"""Host-side utilities."""

from .u256_host import (  # noqa: F401
    NUM_LIMBS, address_to_u256, batch_from_limbs, batch_to_limbs,
    contract_bytecode_to_words, from_limbs, to_limbs, u256_to_address,
)
