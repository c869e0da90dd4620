"""Generate the C decode tables from the port's ISA layer (single source of
truth: isa.opcodes.table_arrays)."""

from __future__ import annotations


def tables_text() -> str:
    """The text of `tables.h`: the variant table, its prices, and the panic
    and nop variants."""
    from ..isa.opcodes import NOP_VARIANT_INDEX, PANIC_VARIANT_INDEX, table_arrays

    arrs = table_arrays()
    packed = arrs["packed"]
    price = arrs["price"]
    lines = ["// generated by era_zk_evm_tpu_torch.native.gen_tables — do not "
             "edit",
             "#include <stdint.h>",
             f"static const uint32_t VARIANT_PACKED[{len(packed)}] = {{"]
    lines.append(",".join(str(int(x)) for x in packed) + "};")
    lines.append(f"static const uint32_t VARIANT_PRICE[{len(price)}] = {{")
    lines.append(",".join(str(int(x)) for x in price) + "};")
    lines.append(f"static const uint32_t PANIC_VARIANT = {PANIC_VARIANT_INDEX};")
    lines.append(f"static const uint32_t NOP_VARIANT = {NOP_VARIANT_INDEX};")
    return "\n".join(lines)
