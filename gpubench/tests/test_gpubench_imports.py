"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level names, and the reference loads nothing of the program."""
import subprocess
import sys

from _small import ROOT

from gpubench import run

LOAD = ("import sys; sys.path.insert(0, {root!r}); "
        "import gpubench.run as r; "
        "from gpubench.harness import cell, population, trace; "
        "from gpubench.reference import judge; "
        "from gpubench.arith import flops, busy, sampler_cost; "
        "{extra}"
        "print(sorted({{n.split('.')[0] for n in sys.modules}}))")


def _loaded(extra=""):
    out = subprocess.run([sys.executable, "-c", LOAD.format(
        root=str(ROOT), extra=extra)], capture_output=True, text=True,
        check=True, timeout=300)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    names = _loaded(
        "import dist_dqn_tpu_torch.population, dist_dqn_tpu_torch.envs, "
        "dist_dqn_tpu_torch.models, dist_dqn_tpu_torch.ops.sampler; ")
    assert "dist_dqn_tpu_torch" in names
    assert not names & set(run.BANNED), names & set(run.BANNED)


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded()
    assert "dist_dqn_tpu_torch" not in names
    assert not names & set(run.BANNED)


def test_banned_names_are_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    for name in list(fake):
        if name.split(".")[0] in run.BANNED:
            del fake[name]
    fake.update({"dist_dqn_tpu_torch.x": None, "jaxfoo": None,
                 "flaxen": None})
    monkeypatch.setattr(sys, "modules", fake)
    assert run.banned_modules() == []
    fake["dist_dqn_tpu.ops"] = None
    fake["jax"] = None
    assert run.banned_modules() == ["dist_dqn_tpu", "jax"]
