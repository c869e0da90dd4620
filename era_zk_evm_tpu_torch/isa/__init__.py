"""Layer 0 — the EraVM ISA as data (SURVEY.md §2.9).

Submodules:
  * :mod:`params`    — every pinned constant, with provenance grades.
  * :mod:`opcodes`   — opcode families, sub-variants, the variant table.
  * :mod:`encoding`  — the 8-byte production instruction encoding.
  * :mod:`abi`       — fat pointers, call/ret ABIs, versioned code hashes.
  * :mod:`assembler` — a tiny assembler for conformance-test programs.
"""

from . import abi, assembler, encoding, opcodes, params  # noqa: F401
