"""Block-level checkpoint / resume for the batched VM.

The port of `era_zk_evm_tpu/models/checkpoint.py`, in its format: a
checkpoint is a directory with `state.npz`, every state field in the
reference layout with the JAX package's dtypes (`state.state_to_numpy`),
and `config.json`, `dataclasses.asdict` of the `VmConfig`.  The two
packages' `VmConfig`s have the same fields, so a checkpoint written by
either package loads in the other.  Resume is bit-exact: the cycle step is
a function of (state, config) alone.  Multi-device runs re-shard on load
by passing a mesh (`parallel.make_mesh`).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from ..config import VmConfig
from .state import (
    DEFAULT_DEVICE, BatchedVmState, state_from_numpy, state_to_numpy,
)


def save_checkpoint(path: str | pathlib.Path, state: BatchedVmState,
                    config: VmConfig) -> None:
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path / "state.npz", **state_to_numpy(state))
    (path / "config.json").write_text(json.dumps(dataclasses.asdict(config)))


def load_checkpoint(path: str | pathlib.Path, mesh=None,
                    axis_name: str = "dp",
                    device: torch.device | str = DEFAULT_DEVICE):
    """-> (state, config), the state on `device` (the card unless the
    caller asks for another), or, given a mesh, a `parallel.ShardedState`
    over it."""
    path = pathlib.Path(path)
    config = VmConfig(**json.loads((path / "config.json").read_text()))
    with np.load(path / "state.npz") as data:
        if mesh is None:
            return state_from_numpy(data, device), config
        state = state_from_numpy(data, "cpu")
    from ..parallel import shard_state

    return shard_state(state, mesh, axis_name), config
