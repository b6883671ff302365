"""The port's one-process-per-card runtime (parallel/multihost.py) and
exchange buffers (parallel/peer.py), the counterparts of
tests/test_multihost.py: the XFB_* environment contract (a no-op without
it; a missing rank's error names XFB_PROCESS_ID), the backend choice, and
two real CPU ranks on gloo (tests/torch_multihost_worker.py smoke):
is_primary on rank 0 alone, gather_to_host exact (float32 and complex64),
the /dev/shm exchange buffers mapped by every rank, each rank's written
source read by its peer through the pointer table, the file names gone
once mapped, and the ranked a2a plain versions bit for bit the stacked
ones."""

import os

import pytest
import torch

import torch_multihost_worker as worker
from xlab_fftbarotropic_torch.parallel import (ShardGroup, make_mesh,
                                               make_mesh2d, multihost)

_ENV = ("XFB_COORDINATOR", "XFB_NUM_PROCESSES", "XFB_PROCESS_ID",
        "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_initialize_is_a_noop_without_config(clean_env):
    assert multihost.initialize() is False
    assert not multihost.is_initialized()
    assert multihost.is_primary() and multihost.rank() == 0
    assert multihost.world_size() == 1 and multihost.host_count() == 1
    x = torch.arange(4.0).reshape(1, 2, 2)
    assert torch.equal(multihost.gather_to_host(x), x)
    # without the runtime make_mesh(None) is the one stacked shard
    g = make_mesh(None, "cpu")
    assert g.rank is None and not g.distributed and g.local_shards == 1
    assert make_mesh2d((2, 2), "cpu").local_shards == 4


def test_missing_rank_names_the_variable(clean_env):
    clean_env.setenv("XFB_COORDINATOR", "127.0.0.1:1")
    clean_env.setenv("XFB_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="XFB_PROCESS_ID"):
        multihost.initialize()
    clean_env.setenv("XFB_PROCESS_ID", "2")
    with pytest.raises(ValueError, match=r"rank 2 outside \[0, 2\)"):
        multihost.initialize()
    assert not multihost.is_initialized()


def test_backend_is_chosen_not_fallen_back_to(monkeypatch):
    """gloo on the CPU and for ranks sharing a card, NCCL for one card
    each; cuda without a card raises."""
    assert multihost.choose_backend("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.choose_backend("cuda", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.choose_backend("cuda", 4) == "nccl"
    assert multihost.choose_backend("cuda", 2) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.choose_backend("cuda", 4)


def test_rank_devices(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [multihost.local_device_index(r) for r in range(4)] == [0, 1,
                                                                   0, 1]
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.local_device_index(0) == 3
    assert multihost.rank_device("cpu") == torch.device("cpu")
    g = ShardGroup(4, torch.device("cpu"), (2, 2), rank=1)
    assert g.distributed and g.local_shards == 1
    with pytest.raises(ValueError, match="does not hold"):
        ShardGroup(4, torch.device("cpu"), (3, 2), rank=1)


def test_two_ranks_gather_and_map_the_exchange_buffers(tmp_path):
    outs = worker.launch(2, ["smoke", tmp_path])
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-3000:]}"
        assert f"DONE {rank}" in out
        assert f"rank {rank} of 2, backend gloo" in err
    got = {line["case"]: line for line in worker.lines(outs[0][1])}
    assert worker.lines(outs[1][1]) == []       # rank 0 alone prints
    assert got["is_primary"]["flags"] == [True, False]
    assert got["gather"] == dict(case="gather", exact=True,
                                 complex_exact=True, shape=[2, 2, 3])
    ex = got["exchange"]
    # every rank's source, written by it, read by both through the table
    assert ex["seen"] == [1.0, 2.0]
    assert ex["names_left"] == []
    assert ex["cols_exact"] and ex["rows_exact"]
    # the two transposes: put and take, two barriers each, after the
    # smoke's own put and barrier
    assert ex["barriers"] == 2 + 4
    from xlab_fftbarotropic_torch.parallel import peer

    assert not list(peer.SHM_DIR.glob(ex["tag"] + "*"))
    assert os.path.isdir(peer.SHM_DIR)
