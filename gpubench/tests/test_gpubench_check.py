"""The check that decides ``correct``, at a small size on the CPU: the
reference agrees with the program, the control in lower precision does
not, and each fault planted in the program turns ``correct`` false."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from _small import CELLS, ROOT, SMALL, TRAFFIC

from gpubench import run
from gpubench.harness import cell as cells
from gpubench.harness.population import Population
from gpubench.reference import judge

SEED = 2**31 + 12345


def _run(name, seed=SEED, device="cpu"):
    return run.run_cell(name, seed, 0.5, False, device=device,
                        overrides=SMALL, traffic_overrides=TRAFFIC[name])


def _capture(name, seed=SEED, device="cpu"):
    pop = Population(cells.cell(name), seed, device, SMALL, TRAFFIC[name])
    pop.fill()
    pop.check_steps()
    return pop.capture


# Numbers whose limits hold at this small size as at the cell's: the
# learner's numbers carry bfloat16 noise that a batch of 16 does not
# average down, so they are held against the bfloat16 witness instead.
EXACT = ("prio_gap", "draw_gap", "weight_gap", "plane_gap", "act_gap")


def _agrees(name, device):
    result = _run(name, device=device)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for number in EXACT:
        check = result["checks"].get(number)
        if check is not None:
            assert check["value"] <= check["limit"], (number, check)
    cap = _capture(name, device=device)
    got = judge.readings(cap, device=device)
    witness = judge.control_readings(cap, device=device)
    for number in ("loss_gap", "grad_gap", "update_gap"):
        assert got[number] <= 4 * witness["bf16"][number] + 1e-4, (
            number, got[number], witness["bf16"][number])
        assert got[number] < witness["fp8"][number], number


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    _agrees(name, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_control_in_float8_fails_a_limit(name):
    cap = _capture(name)
    limits = cells.cell(name)["limits"]
    readings = judge.control_readings(cap)
    failed = [k for k, v in readings["fp8"].items() if v > limits[k]["limit"]]
    assert failed, readings["fp8"]


def _state_unchanged(monkeypatch):
    from dist_dqn_tpu_torch.agents import dqn

    def step(self, params, grads, state):
        M = self.members or 1
        norm = torch.sqrt(sum((g * g).reshape(M, -1).sum(dim=1)
                              for g in grads))
        return norm if self.members else norm[0]

    monkeypatch.setattr(dqn.ClipAdam, "step", step)


def _half_batch(monkeypatch):
    from dist_dqn_tpu_torch.replay import prioritized_device as pring
    draw = pring.prioritized_ring_sample

    def half(*args, **kwargs):
        s = draw(*args, **kwargs)
        h = s.weights.shape[-1] // 2
        return pring.PrioritizedSample(
            batch=type(s.batch)(*(x[:, :h] for x in s.batch)),
            weights=s.weights[:, :h], t_idx=s.t_idx[:, :h],
            b_idx=s.b_idx[:, :h])

    monkeypatch.setattr(pring, "prioritized_ring_sample", half)


def _priorities_altered(monkeypatch):
    from dist_dqn_tpu_torch.replay import prioritized_device as pring
    update = pring.prioritized_ring_update

    def doubled(state, t_idx, b_idx, priorities, eps=1e-6):
        return update(state, t_idx, b_idx, 2 * priorities, eps=eps)

    monkeypatch.setattr(pring, "prioritized_ring_update", doubled)


def _member_hp_swapped(field):
    """Member 0 runs with the next member's learning rate or discount."""
    def plant(monkeypatch):
        from dist_dqn_tpu_torch import population
        member_hp = population.member_hp

        def swapped(cfg, spec):
            hp = member_hp(cfg, spec)
            values = getattr(hp, field).clone()
            values[0] = values[1]
            return hp._replace(**{field: values})

        monkeypatch.setattr(population, "member_hp", swapped)
    return plant


def _actions_altered(monkeypatch):
    from dist_dqn_tpu_torch import train_loop
    make = train_loop.make_actor_step

    def altered(num_actions):
        act = make(num_actions)
        return lambda *a: (act(*a) + 1) % num_actions

    monkeypatch.setattr(train_loop, "make_actor_step", altered)


FAULTS = {"state_unchanged": (_state_unchanged, "update_gap"),
          "half_batch": (_half_batch, "draw_gap"),
          "priorities_altered": (_priorities_altered, "prio_gap"),
          "actions_altered": (_actions_altered, "act_gap"),
          "member_lr": (_member_hp_swapped("lr"), "update_gap"),
          "member_gamma": (_member_hp_swapped("gamma"), "loss_gap")}


def _compares(name, number):
    return cells.cell(name)["limits"].get(number, {}).get("limit") is not None


# Each cell with each fault it can have: a fault whose number the cell
# does not compare (its limits file says why) is another number's to
# catch there, and the priorities' fault is its altered answer.
CASES = [(name, fault) for name in CELLS for fault in sorted(FAULTS)
         if _compares(name, FAULTS[fault][1])]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault,
                                                   monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    result = _run(name)
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"], result["checks"]


def test_no_card_means_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload",
         "apex.pop8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())


def test_a_run_that_raises_prints_correct_false(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", broken)
    code = run.main(["--workload", "apex.pop8", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 1 and last["correct"] is False
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench")
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "apex.pop8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "no program to run" in proc.stderr
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_small(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _agrees(name, "cuda")
    limits = cells.cell(name)["limits"]
    fp8 = judge.control_readings(_capture(name, device="cuda"),
                                 device="cuda")["fp8"]
    assert any(v > limits[k]["limit"] for k, v in fp8.items()), fp8
