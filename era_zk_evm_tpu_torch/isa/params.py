"""Pinned EraVM ISA parameters (capability surface of `zkevm_opcode_defs` v1.4.1).

The reference crate (`/root/reference`, zk_evm v1.4.1) externalizes the ISA
definition into the sibling crate `zkevm_opcode_defs` (branch v1.4.1), which is
NOT vendored in this environment (SURVEY.md §2.9).  Every constant the VM core
actually consumes is therefore pinned *here*, in one module, with a provenance
note.  Provenance grades:

  [V] value is directly evidenced by the reference crate's own sources
      (cited file:line in /root/reference/src).
  [P] value pinned from the public zkevm_opcode_defs / zkSync Era system
      contracts surface (well-known published constants).
  [E] best-effort pin; semantics are exact but the numeric value should be
      re-verified against the public v1.4.1 branch when network access is
      available.  All uses are confined to this module so a correction is a
      one-line change; the golden model and the TPU kernels consume the same
      pin, so internal differential consistency never depends on the grade.

Nothing in this file is copied from the reference; it is a re-specification of
the ISA surface enumerated in SURVEY.md §2.9/§2.10.
"""

# --------------------------------------------------------------------------
# Core machine geometry
# --------------------------------------------------------------------------

#: [P] Number of general-purpose registers r1..r15 (r0 is a hardwired zero
#: expressed by the 4-bit register index 0; reference usage:
#: vm_state/helpers.rs:318-334).
REGISTERS_COUNT = 15

#: [V] 4 opcodes of 8 bytes per 32-byte code word (vm_state/cycle.rs:16-17).
OPCODES_PER_WORD_LOG_2 = 2
OPCODES_PER_WORD = 1 << OPCODES_PER_WORD_LOG_2
INSTRUCTION_BYTES = 8

#: [P] Timestamp advances by this much per non-skipped cycle
#: (vm_state/mod.rs:232-234 consumes it; value from zkevm_opcode_defs).
TIME_DELTA_PER_CYCLE = 4

#: [E] Initial local-state timestamp (vm_state/mod.rs:82).
STARTING_TIMESTAMP = 1024

#: [E] Initial memory page counter (vm_state/mod.rs:85).
STARTING_BASE_PAGE = 2048

#: [P] Pages allocated per far call: base+0 code candidate, base+1 stack,
#: base+2 heap, base+3 aux heap (vm_state/execution_stack.rs:67-81).
NEW_MEMORY_PAGES_PER_FAR_CALL = 4

#: [P] The never-written page used for padding / the empty root context
#: (vm_state/execution_stack.rs:40-41 uses it for the empty frame).
UNMAPPED_PAGE = 0

#: [P] SP value at the start of every far-call frame (EraVM spec: initial
#: stack pointer is 1024; consumed at far_call.rs:543).
INITIAL_SP_ON_FAR_CALL = 1024

#: [E] Page holding bootloader calldata (reference_impls/memory.rs:230-231).
BOOTLOADER_CALLDATA_PAGE = 3

#: [V] Growing heap/aux-heap costs 1 erg per byte (comment at ret.rs:177
#: "MEMORY_GROWTH_ERGS_PER_BYTE is always 1").
MEMORY_GROWTH_ERGS_PER_BYTE = 1

#: [E] Ergs per 32-byte code word decommitted (far_call.rs:423-424).
ERGS_PER_CODE_WORD_DECOMMITTMENT = 4

#: [P] MsgValueSimulator system contract address low 16 bits
#: (far_call.rs:390; feature-gated OFF by FORCED_ERGS_FOR_MSG_VALUE_SIMULATOR).
ADDRESS_MSG_VALUE = 0x8009

# --------------------------------------------------------------------------
# system_params::*
# --------------------------------------------------------------------------

#: [E] Ergs budget of the pre-bootloader root frame (execution_stack.rs:45).
#: Pinned to u32::MAX: the root frame must be able to fund any block.
VM_INITIAL_FRAME_ERGS = (1 << 32) - 1

#: [E] Max callstack depth (callstack `is_full` check, execution_stack.rs:119-121).
VM_MAX_STACK_DEPTH = 1024

#: [E] Free heap/aux-heap bytes granted to every new far-call frame
#: (far_call.rs:553-554).
NEW_FRAME_MEMORY_STIPEND = 1 << 10

#: [P] Pubdata bytes charged for an initial storage write (log.rs:107).
INITIAL_STORAGE_WRITE_PUBDATA_BYTES = 64

#: [P] Pubdata bytes charged per L1 message (log.rs:123):
#: 1 (shard) + 1 (is_service) + 2 (tx idx) + 20 (address) + 32 (key) + 32 (value).
L1_MESSAGE_PUBDATA_BYTES = 1 + 1 + 2 + 20 + 32 + 32

#: [E] MsgValueSimulator stipend parameters (far_call.rs:387-406; the gate
#: FORCED_ERGS_FOR_MSG_VALUE_SIMULATOR is false, so these are inert).
MSG_VALUE_SIMULATOR_ADDITIVE_COST = 11500
MSG_VALUE_SIMULATOR_PUBDATA_BYTES_TO_PREPAY = 64

#: [P] AccountCodeStorage system contract: the storage space holding
#: versioned code hashes, read on every far call (far_call.rs:136).
DEPLOYER_SYSTEM_CONTRACT_ADDRESS = 0x8002

#: [P] LogQuery aux_byte discriminators (log.rs:6-8 imports; values from the
#: public system params: storage=0, event=2, l1 message=3, precompile=4).
STORAGE_AUX_BYTE = 0
EVENT_AUX_BYTE = 2
L1_MESSAGE_AUX_BYTE = 3
PRECOMPILE_AUX_BYTE = 4

#: [P] Precompile formal addresses (keccak lives in kernel space; sha256 and
#: ecrecover keep their EVM addresses).
KECCAK256_ROUND_FUNCTION_PRECOMPILE_ADDRESS = 0x8010
SHA256_ROUND_FUNCTION_PRECOMPILE_ADDRESS = 0x02
ECRECOVER_INNER_FUNCTION_PRECOMPILE_ADDRESS = 0x01

#: [P] Kernel space: addresses < 2^16 are kernel (execution_stack.rs:83-87).
KERNEL_SPACE_BOUND = 1 << 16

#: [E] Number of storage shards (testing/mod.rs:4).
NUM_SHARDS = 2

# --------------------------------------------------------------------------
# Pointer / UMA bounds
# --------------------------------------------------------------------------

#: [P] ptr.add/ptr.sub require src1 < 2^32 (ptr.rs:47).
MAX_OFFSET_FOR_ADD_SUB = 1 << 32

#: [P] UMA heap deref bound: offset+32 must fit in u32, so the largest legal
#: src0 value is 2^32-33 (uma.rs:127 compares with `>`).
MAX_OFFSET_TO_DEREF = (1 << 32) - 33

# --------------------------------------------------------------------------
# Per-opcode flag bit indices (within the 2 non-exclusive variant flag bits)
# --------------------------------------------------------------------------

NUM_NON_EXCLUSIVE_FLAGS = 2

SET_FLAGS_FLAG_IDX = 0            # [P] arithmetic/binop/shift/... (add.rs:32-33)
SWAP_OPERANDS_FLAG_IDX = 1        # [P] sub/div/shift variants (cycle.rs:341-345)
UMA_INCREMENT_FLAG_IDX = 0        # [P] uma.rs:55
FIRST_MESSAGE_FLAG_IDX = 0        # [P] log.rs:43
RET_TO_LABEL_BIT_IDX = 0          # [P] ret.rs:51
FAR_CALL_STATIC_FLAG_IDX = 0      # [P] far_call.rs:71
FAR_CALL_SHARD_FLAG_IDX = 1       # [P] far_call.rs:72

# --------------------------------------------------------------------------
# Far-call / ret register-file protocol (definitions::far_call / ::ret)
# --------------------------------------------------------------------------
# Register indices here are 0-based into the 15-entry register file
# (i.e. value k means architectural register r{k+1}).

CALL_IMPLICIT_CALLDATA_FAT_PTR_REGISTER = 0       # [P] r1 (far_call.rs:577)
CALL_IMPLICIT_CONSTRUCTOR_MARKER_REGISTER = 1     # [P] r2 (far_call.rs:587)
CALL_SYSTEM_ABI_REGISTERS = range(2, 12)          # [E] r3..r12 (far_call.rs:594-603)
CALL_RESERVED_RANGE = range(12, 14)               # [E] r13, r14 (far_call.rs:606)
CALL_IMPLICIT_PARAMETER_REG_IDX = 14              # [E] r15 (far_call.rs:507)

RET_IMPLICIT_RETURNDATA_PARAMS_REGISTER = 0       # [P] r1 (ret.rs:213)
RET_RESERVED_REGISTER_0 = 1                       # [P] r2 (ret.rs:218)
RET_RESERVED_REGISTER_1 = 2                       # [P] r3 (ret.rs:220)
RET_RESERVED_REGISTER_2 = 3                       # [P] r4 (ret.rs:222)

# --------------------------------------------------------------------------
# Versioned code hash format (ContractCodeSha256)
# --------------------------------------------------------------------------
# 32-byte big-endian layout (far_call.rs:169-252 consumes it):
#   byte 0      version marker (1)
#   byte 1      extra marker: 0 = code at rest, 1 = yet constructed
#   bytes 2..4  code length in 32-byte words, big-endian u16
#   bytes 4..32 low 28 bytes of sha256(code)
CODE_HASH_VERSION_BYTE = 1                        # [P]
CODE_AT_REST_MARKER = 0                           # [P]
YET_CONSTRUCTED_MARKER = 1                        # [P]

# --------------------------------------------------------------------------
# Reference-impl memory geometry (zk_evm_abstractions aux consts)
# --------------------------------------------------------------------------

MAX_CODE_PAGE_SIZE_IN_WORDS = 1 << 16             # [E] memory.rs:8-9 usage
MAX_STACK_PAGE_SIZE_IN_WORDS = 1 << 16            # [E]

# --------------------------------------------------------------------------
# Ergs price model (OPCODES_PRICES inputs)
# --------------------------------------------------------------------------
# The reference looks prices up per variant index (cycle.rs:147-148).  The
# price of a variant depends only on its opcode family + whether src0 uses a
# memory operand; the table itself is synthesized in isa/opcodes.py from the
# atoms below ([E] — circuit-cost-derived values from the public crate).

VM_CYCLE_COST_IN_ERGS = 4
RAM_PERMUTATION_COST_IN_ERGS = 1
#: base cost of an opcode whose variant addresses memory for src0/dst0
RICH_ADDRESSING_OPCODE_ERGS = VM_CYCLE_COST_IN_ERGS + 2 * RAM_PERMUTATION_COST_IN_ERGS
#: base cost of a register/imm-only variant
AVERAGE_OPCODE_ERGS = VM_CYCLE_COST_IN_ERGS + RAM_PERMUTATION_COST_IN_ERGS

STORAGE_READ_IO_PRICE = 150
STORAGE_WRITE_IO_PRICE = 250
EVENT_IO_PRICE = 25
L1_MESSAGE_IO_PRICE = 100
CALL_LIKE_ERGS_COST = 20
PRECOMPILE_CALL_BASE_PRICE = 10

#: [E] UMA touches up to 2 words read + 2 words written
UMA_ERGS = VM_CYCLE_COST_IN_ERGS + 5 * RAM_PERMUTATION_COST_IN_ERGS
NEAR_CALL_ERGS = AVERAGE_OPCODE_ERGS + CALL_LIKE_ERGS_COST
#: [E] far call burns storage read + callstack sponges (far_call.rs:29-32)
FAR_CALL_ERGS = 2 * VM_CYCLE_COST_IN_ERGS + RAM_PERMUTATION_COST_IN_ERGS \
    + STORAGE_READ_IO_PRICE + CALL_LIKE_ERGS_COST
RET_ERGS = AVERAGE_OPCODE_ERGS
#: price of the masked panic (invalid opcode decodes as Ret::Panic variant)
INVALID_OPCODE_ERGS = (1 << 32) - 1
