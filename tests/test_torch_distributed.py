"""The port's multi-process launch (``rsis_tpu_torch/parallel``), as
``tests/test_distributed.py`` tests JAX's: the single-process no-op,
``global_batch_slice`` under a patched rank and world size, a real
2-process gloo handshake on a localhost coordinator (batch slicing,
``shard_batch`` and a global sum of 28.0 over the ranks, through
``tests/torch_dist_worker.py``), ``shard_batch``'s divisibility error and
the (dcn, data) grids of ``create_multislice_mesh`` at (2, 1) and (1, 2)
(checked in the same handshake)."""

import numpy as np
import pytest
import torch

from rsis_tpu_torch.parallel import (Group, create_mesh, distributed,
                                     global_batch_slice, initialize,
                                     shard_batch)
from torch_dist_worker import launch
from torch_threads import one_torch_thread  # noqa: F401


def test_single_process_noop():
    assert initialize() is False  # no flags: nothing happens
    assert not torch.distributed.is_initialized()
    group = create_mesh(device="cpu")
    assert (group.rank, group.size, group.active) == (0, 1, False)
    batch = (np.arange(6), np.ones((6, 2)))
    assert shard_batch(group, batch) is batch


def test_global_batch_slice(monkeypatch):
    assert global_batch_slice(32) == (32, 0)  # one process
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    assert global_batch_slice(32) == (8, 16)
    with pytest.raises(ValueError, match="not divisible"):
        global_batch_slice(30)


def test_two_process_handshake(tmp_path):
    """Two real processes: initialize on a localhost coordinator (gloo),
    global_batch_slice, shard_batch, a global sum over the ranks and the
    multislice grids."""
    outs = launch({"world": 2, "mode": "handshake"}, tmp_path, timeout=120)
    for i, out in enumerate(outs):
        assert f"proc {i}: OK global_sum=28.0" in out, out


def test_shard_batch_divisibility():
    group = Group(1, 4, torch.device("cpu"))
    img, tgt = shard_batch(group, (np.arange(8), torch.arange(16).view(8, 2)))
    assert img.tolist() == [2, 3] and tgt.tolist() == [[4, 5], [6, 7]]
    assert shard_batch(group, {"x": np.arange(4)})["x"].tolist() == [1]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(group, (np.zeros((6, 3)),))


def test_mesh_needs_the_process_group():
    with pytest.raises(ValueError, match="processes"):
        create_mesh(2, device="cpu")
    from rsis_tpu_torch.parallel import create_multislice_mesh
    with pytest.raises(ValueError, match="process group"):
        create_multislice_mesh(2, 1, device="cpu")
