"""End-to-end sharded runs over torch.distributed ranks: the counterpart
of tests/test_multihost_run.py for the port. 2 CPU ranks (gloo) run
xlab_fftbarotropic_torch.cli.run.main --shard (x-pencil, the a2a plain
versions on the exchange buffers) into one shared output directory
(tests/torch_multihost_worker.py cli): every rank gathers, rank 0 alone
writes, so there is one manifest with each record once, one record set
and the checkpoints. The records match the JAX package's single-process
run of the same configuration to 1e-6 of max; the 2 ranks' records and
checkpoints are bit for bit the same command's on 2 stacked shards in
one process (runner.shard_mesh made to return make_mesh(2)), and
round-off apart from the one-process --shard run's on its one shard (a
rank's x-DFT runs on contiguous rows, dfft.fft_x ranked, the one stacked
shard's strided): the state within rel-L2 1e-7, each record, one more
inverse transform of it, within rel-L2 4 float32 epsilons. A checkpoint
resumes across rank counts: the one process's on 2 ranks bit for bit
the 2 stacked shards resumed from it, and the 2 ranks' in one process
within the same bars of the uninterrupted 2-rank run."""

from pathlib import Path

import numpy as np
import pytest

import torch_multihost_worker as worker
from xlab_fftbarotropic_torch import runner
from xlab_fftbarotropic_torch.cli import run as tcli
from xlab_fftbarotropic_torch.config import ModelConfig
from xlab_fftbarotropic_torch.ic import makefields
from xlab_fftbarotropic_torch.io.fieldio import read_field, write_field
from xlab_fftbarotropic_torch.parallel import make_mesh
from torch_threads import _one_thread  # noqa: F401

N, STEPS, REC, CKPT = 32, 6, 2, 2
FIELDS = ("vort", "psi", "u", "v")
SHARD = ["--shard", "--shard-fft", "pallas", "--decomp", "xpencil"]
# one shard against two: the state's rel-L2 and a record's (4 eps32)
STATE_TOL = 1e-7
FIELD_TOL = 4 * float(np.finfo(np.float32).eps)


def _args(tmp: Path, out: str, *extra) -> list:
    return ["-I", str(tmp / "input"), "-O", str(tmp / out), "--nx", str(N),
            "--ny", str(N), "--total-steps", str(STEPS), "--record-step",
            str(REC), "--checkpoint-step", str(CKPT), "--device", "cpu",
            "--manifest", str(tmp / f"{out}.log"), *SHARD, *extra]


def _ranks(tmp: Path, args: list) -> None:
    outs = worker.launch(2, ["cli", tmp, "--", *args])
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-3000:]}"
        assert f"DONE {rank}" in out
        assert "Program ends" in err


def _record(tmp: Path, out: str, name: str, step: int) -> np.ndarray:
    return read_field(tmp / out / f"{name}_step_{step}.bin", (N, N))


def _ckpt(tmp: Path, out: str, step: int) -> dict:
    """A checkpoint's arrays but its config (which names its output
    directory)."""
    with np.load(tmp / out / f"ckpt_step_{step}.npz") as z:
        return {k: z[k] for k in z.files if k != "config_json"}


def _stacked(tmp: Path, args: list) -> None:
    """The command in this process on 2 stacked shards: the stacked
    model the ranks hold their shards of."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "shard_mesh",
                   lambda device, decomp, mesh_shape: make_mesh(2, "cpu"))
        assert tcli.main(args) == 0


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs: 2 ranks ('two'), 2 stacked shards in one process
    ('stk'), one process on one shard ('one'), the JAX package ('jax'),
    the 2 ranks' checkpoint resumed in one process ('one_r'), the one
    process's on 2 ranks ('two_r') and on 2 stacked shards ('stk_r')."""
    tmp = tmp_path_factory.mktemp("runs")
    (tmp / "input").mkdir()
    cfg = ModelConfig(nx=N, ny=N)
    write_field(str(tmp / "input" / "initial_vorticity.bin"),
                np.asarray(makefields.gaussian(cfg), np.float32))
    _ranks(tmp, _args(tmp, "two"))
    _stacked(tmp, _args(tmp, "stk"))
    assert tcli.main(_args(tmp, "one")) == 0
    from xlab_fftbarotropic_tpu import runner as jrunner
    from xlab_fftbarotropic_tpu.config import ModelConfig as JConfig

    jrunner.run(JConfig(nx=N, ny=N, total_steps=STEPS, record_step=REC,
                        input_dir=str(tmp / "input"),
                        output_dir=str(tmp / "jax")),
                manifest_path=str(tmp / "jax.log"))
    assert tcli.main(_args(tmp, "one_r", "--resume-from",
                           str(tmp / "two" / f"ckpt_step_{CKPT}.npz"))) == 0
    one_ckpt = str(tmp / "one" / f"ckpt_step_{CKPT}.npz")
    _ranks(tmp, _args(tmp, "two_r", "--resume-from", one_ckpt))
    _stacked(tmp, _args(tmp, "stk_r", "--resume-from", one_ckpt))
    return tmp


def test_rank_zero_alone_writes(runs):
    log = (runs / "two.log").read_text().split()
    assert len(log) == len(set(log))
    want = {str(runs / "two" / f"{f}_step_{s}.bin")
            for f in FIELDS + ("vort_src_input",) for s in range(0, STEPS,
                                                                 REC)}
    assert set(log) == want
    assert sorted(p.name for p in (runs / "two").glob("ckpt_*")) == [
        f"ckpt_step_{s}.npz" for s in range(CKPT, STEPS, CKPT)]
    assert not list(runs.glob("two/*.tmp*"))


def test_records_match_jax_and_one_process(runs):
    for step in range(0, STEPS, REC):
        for name in FIELDS:
            got = _record(runs, "two", name, step)
            want = _record(runs, "jax", name, step)
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= 1e-6 * scale, (
                name, step)
            assert np.array_equal(got, _record(runs, "stk", name, step))
            assert _rel(got, _record(runs, "one", name, step)) <= (
                FIELD_TOL), (name, step)
    last = STEPS - CKPT
    two, stk, one = (_ckpt(runs, o, last) for o in ("two", "stk", "one"))
    assert two.keys() == stk.keys() == one.keys()
    for k in two:
        assert np.array_equal(two[k], stk[k]), k
        if np.iscomplexobj(two[k]):
            assert _rel(two[k], one[k]) <= STATE_TOL, k
        else:
            assert np.array_equal(two[k], one[k]), k


def test_checkpoints_resume_across_rank_counts(runs):
    last = STEPS - CKPT
    pairs = (("two_r", "stk_r", True), ("two_r", "one", False),
             ("one_r", "two", False))
    for a, b, exact in pairs:
        ca, cb = _ckpt(runs, a, last), _ckpt(runs, b, last)
        assert ca.keys() == cb.keys()
        for k in ca:
            if exact or not np.iscomplexobj(ca[k]):
                assert np.array_equal(ca[k], cb[k]), (a, b, k)
            else:
                assert _rel(ca[k], cb[k]) <= STATE_TOL, (a, b, k)
        for step in range(CKPT, STEPS, REC):
            for name in FIELDS:
                ra, rb = _record(runs, a, name, step), _record(runs, b,
                                                               name, step)
                if exact:
                    assert np.array_equal(ra, rb), (a, b, name, step)
                else:
                    assert _rel(ra, rb) <= FIELD_TOL, (a, b, name, step)
