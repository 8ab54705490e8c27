"""The port's C++ n-step assembler (dist_dqn_tpu_torch/actors/_native/
assembler.cc, built with g++ into ``build/dist_dqn_tpu_torch/``) against
the Python assemblers, the port's and the JAX package's: the same random
step streams (numpy, seeded), drained at random points and through
``reset``, give exactly equal transitions, dtypes included, for every
obs dtype the JAX package's ``test_native_matches_python_exactly`` takes.
Exact because the port's copy folds the return and discount in double and
rounds once, as the Python fold does (the JAX package's C++ copy folds in
float and agrees to rtol 1e-5 only, queue C of ROADMAP.md)."""
from pathlib import Path

import numpy as np
import pytest

from dist_dqn_tpu.actors.assembler import NStepAssembler as JaxNStep
from dist_dqn_tpu_torch.actors import assembler as tasm
from dist_dqn_tpu_torch.actors.transport import build_native_lib

REPO = Path(__file__).resolve().parents[1]


def _random_stream(rng, lanes, steps, obs_shape=(5,), dtype=np.float32):
    for _ in range(steps):
        if dtype == np.uint8:
            obs = rng.integers(0, 255, (lanes,) + obs_shape).astype(dtype)
            nxt = rng.integers(0, 255, (lanes,) + obs_shape).astype(dtype)
        else:
            obs = rng.normal(size=(lanes,) + obs_shape).astype(dtype)
            nxt = rng.normal(size=(lanes,) + obs_shape).astype(dtype)
        yield (obs,
               rng.integers(0, 6, (lanes,)).astype(np.int32),
               rng.normal(size=(lanes,)).astype(np.float32),
               rng.random((lanes,)) < 0.05,
               rng.random((lanes,)) < 0.03,
               nxt)


def _assert_same(outs):
    first = outs[0]
    for other in outs[1:]:
        assert (first is None) == (other is None)
        if first is None:
            continue
        assert set(first) == set(other)
        for k in first:
            assert first[k].dtype == other[k].dtype, k
            np.testing.assert_array_equal(first[k], other[k], err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_native_matches_python_exactly(dtype):
    rng = np.random.default_rng(0)
    lanes, steps, n, gamma = 3, 400, 3, 0.97
    asms = [tasm.NStepAssembler(lanes, n, gamma),
            tasm.NativeNStepAssembler(lanes, n, gamma),
            JaxNStep(lanes, n, gamma)]
    emitted = 0
    for rec in _random_stream(rng, lanes, steps, dtype=dtype):
        for a in asms:
            a.step(*rec)
        if rng.random() < 0.1:
            outs = [a.drain() for a in asms]
            _assert_same(outs)
            emitted += 0 if outs[0] is None else len(outs[0]["action"])
    _assert_same([a.drain() for a in asms])
    assert emitted > 500


def test_native_reset_matches_python():
    rng = np.random.default_rng(1)
    lanes = 2
    asms = [tasm.NStepAssembler(lanes, 4, 0.9),
            tasm.NativeNStepAssembler(lanes, 4, 0.9),
            JaxNStep(lanes, 4, 0.9)]
    stream = list(_random_stream(rng, lanes, 40, obs_shape=(2, 3)))
    for i, rec in enumerate(stream):
        if i in (3, 17):
            _assert_same([a.drain() for a in asms])
            for a in asms:
                a.reset()
        for a in asms:
            a.step(*rec)
    _assert_same([a.drain() for a in asms])


def test_native_drain_views_and_the_build():
    rng = np.random.default_rng(2)
    cc = tasm.NativeNStepAssembler(2, 2, 0.5)
    assert cc.drain() is None
    for rec in _random_stream(rng, 2, 6):
        cc.step(*rec)
    view = cc.drain(copy=False)
    assert view["obs"].base is not None and view["action"].shape[0] >= 2
    assert cc.drain() is None
    path = build_native_lib("assembler.cc", "libdqnassembler.so")
    assert path.parent == REPO / "build" / "dist_dqn_tpu_torch"
    assert path.name.startswith("libdqnassembler_")
    src = REPO / "dist_dqn_tpu_torch" / "actors" / "_native" / "assembler.cc"
    assert src.exists()
    assert tasm._assembler_lib() is tasm._assembler_lib()


def test_native_overflow_raises():
    rng = np.random.default_rng(3)
    cc = tasm.NativeNStepAssembler(2, 2, 0.9, arena_capacity=3)
    with pytest.raises(RuntimeError, match="arena overflow"):
        for rec in _random_stream(rng, 2, 10):
            cc.step(*rec)


def test_failed_build_falls_back_with_the_jax_line(monkeypatch):
    """When the C++ assembler does not build, the bootstrap path logs the
    JAX service's line word for word and runs the Python assembler; the
    summary's ``assembler`` says which ran."""
    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.actors import assembler as jasm
    from dist_dqn_tpu.actors import service as jservice
    from dist_dqn_tpu_torch import config as tconfig
    from dist_dqn_tpu_torch.actors import service as tservice

    def broken():
        raise RuntimeError("g++ failed (1): no compiler")

    monkeypatch.setattr(tasm, "_assembler_lib", broken)
    monkeypatch.setattr(jasm, "_assembler_lib", broken)
    overrides = ["network.torso=mlp", "network.mlp_features=(16,)",
                 "network.hidden=0", "network.compute_dtype=float32"]
    kw = dict(actor_priorities=False)
    tlog, jlog = [], []
    ours = tservice.ApexLearnerService(
        tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], overrides),
        tservice.ApexRuntimeConfig(**kw), log_fn=tlog.append, device="cpu")
    theirs = jservice.ApexLearnerService(
        jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], overrides),
        jservice.ApexRuntimeConfig(**kw), log_fn=jlog.append)
    try:
        want = [line for line in jlog if "native assembler" in line]
        assert want == [line for line in tlog if "native assembler" in line]
        assert want == ["# native assembler unavailable (RuntimeError: g++ "
                        "failed (1): no compiler); using Python path"]
        assert ours.assembler_kind == "python"
        assert ours.summary()["assembler"] == "python"
        assert all(type(a) is tasm.NStepAssembler for a in ours.assemblers)
    finally:
        ours.shutdown()
        theirs.shutdown()
