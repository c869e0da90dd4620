"""Static geometry of the batched VM, mirrored from the JAX package.

`VmConfig` has the same field names, defaults and checks as
`era_zk_evm_tpu/models/state.py::VmConfig`, so one configuration means the
same thing to both engines; `tests/test_torch_config_state.py` fails if the
two drift apart.  This module imports neither jax nor torch.
"""

from __future__ import annotations

import dataclasses

from .isa import params

#: max memory queries one cycle can emit: the 8-slot block of the memory
#: witness queue (era_zk_evm_tpu/models/batched_vm.py SLOTS_PER_CYCLE)
SLOTS_PER_CYCLE = 8


@dataclasses.dataclass(frozen=True)
class VmConfig:
    """Static geometry of the batched VM (tensor shapes)."""

    batch: int
    code_words: int = 64
    stack_words: int = 2048
    heap_words: int = 512
    aux_heap_words: int = 64
    max_depth: int = 32
    queue_capacity: int = 0
    stack_abs_words: int | None = None
    stack_sp_base: int = 768
    storage_slots: int = 0
    journal_slots: int = 0
    event_slots: int = 0
    log_queue_capacity: int = 0
    heap_frames: int = 1
    code_pages: int = 1
    decommit_queue_capacity: int = 0
    precompile_keccak_blocks: int = 0
    precompile_sha_rounds: int = 0
    precompile_ecrecover: bool = False
    precompile_queue_capacity: int = 0
    rolling_commitment: bool = False
    limb_major_arenas: bool = False
    #: accepted for parity with the JAX config; it has no semantic effect
    sweep_gating: bool = True

    def __post_init__(self):
        if self.stack_abs_words is None:
            assert self.stack_words > params.INITIAL_SP_ON_FAR_CALL
        else:
            assert self.stack_sp_base <= params.INITIAL_SP_ON_FAR_CALL \
                < self.stack_sp_base + self.stack_words - self.stack_abs_words
        if self.queue_capacity:
            assert self.queue_capacity % 8 == 0
        if self.precompile_queue_capacity:
            ps_in, ps_out = precompile_queue_slots(self)
            assert self.precompile_queue_capacity >= ps_in + ps_out


def precompile_queue_slots(config: VmConfig) -> tuple[int, int]:
    """(input, output) witness slots per precompile call."""
    ins = 1
    if config.precompile_keccak_blocks:
        ins = max(ins, (config.precompile_keccak_blocks * 136 + 61) // 32)
    if config.precompile_sha_rounds:
        ins = max(ins, 2 * config.precompile_sha_rounds)
    if config.precompile_ecrecover:
        ins = max(ins, 4)
    outs = 2 if config.precompile_ecrecover else 1
    return ins, outs


# callstack scalar fields, all u32[B, D]
CS_SCALAR_FIELDS = (
    "base_memory_page", "code_page", "sp", "pc", "exception_handler",
    "ergs_remaining", "shard_ids",  # shard_ids packs this|caller<<8|code<<16
    "flags_word",                   # bit0 is_static, bit1 is_local_frame
    "heap_bound", "aux_heap_bound",
    "journal_snapshot", "event_snapshot",
    "heap_slot",
)

CS = {name: i for i, name in enumerate(CS_SCALAR_FIELDS)}

#: the state fields stored batch-last ([..., B])
BATCH_LAST_FIELDS = ("wq_meta", "wq_value", "wq_flags")


def from_jax_config(cfg) -> VmConfig:
    """The port's config equal to a JAX `VmConfig` (or any dataclass with
    the same fields)."""
    return VmConfig(**dataclasses.asdict(cfg))


def check_slice(config: VmConfig) -> None:
    """Raise NotImplementedError for the one config outside the port: the
    TPU-only `limb_major_arenas` layout.

    Every other config runs as in the JAX jnp engine.  The LOG unit (the
    LOG family and FAR_CALL, with their storage, journal and event slots
    and the log and decommit witness queues) is on when `storage_slots >
    0`; without it every LOG opcode and FAR_CALL sets `lane_error`.  The
    precompile units (keccak256, sha256 and, with `precompile_ecrecover`,
    ecrecover, with their round-witness queue) are on when the LOG unit is
    and `precompile_keccak_blocks > 0` (the JAX engines turn them on by the
    keccak block count alone: sha256 then runs at least one round, and
    sha256 rounds without keccak blocks run no unit).  Without the units,
    `log.precompile` sets `lane_error`, `precompile_ecrecover` is inert and
    the precompile queue (`pq_*`) keeps its shapes and initial values.  The
    rolling commitment may run beside the memory queue, as in the JAX jnp
    engine (its fused engine refuses that pair).
    """
    if config.limb_major_arenas:
        raise NotImplementedError("limb_major_arenas (a TPU-only layout)")
