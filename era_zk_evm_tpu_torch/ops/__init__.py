"""Plain torch u256 limb arithmetic and keccak-f[1600]."""
