"""Model-FLOPs accounting of the port (twin of
``dist_dqn_tpu/utils/flops.py``): program FLOPs and bytes, MFU against the
card's peak, and the analytic counts they are held to.

The JAX package takes a program's FLOPs and bytes from XLA's cost
analysis of the compiled program. The port has no compiled program to
ask, so :func:`census` counts one execution of a callable as it runs, in
one dispatch mode: FLOPs by the formulas of
``torch.utils.flop_counter``'s registry (matmuls, convolutions and
attention, forward and backward; the counts ``FlopCounterMode`` gives),
bytes as the sum of every aten op's operand and result bytes. The
callable runs on deep copies of its arguments (:func:`fork`), never on
the live state. ``tests/test_torch_flops.py`` holds the census to the analytic
Nature-CNN count and to JAX's census of the same step.

Peaks are the card's published dense bf16 FLOP/s and HBM bytes/s, keyed
on ``torch.cuda.get_device_name``: the training programs run their convs
and matmuls in bf16 (config ``compute_dtype``), so the bf16 peak is the
honest denominator. An unknown card, or the CPU, has no peak (``None``).

Stdlib at import: torch is imported inside the functions that use it, so
the torch-free actor processes can import the telemetry plane that
imports this module.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional

# torch.cuda.get_device_name -> dense bf16 peak FLOP/s per card. NVIDIA's
# H100 data sheet, SXM5 part at its 700 W power limit, dense rates without
# sparsity: 989.4 TFLOP/s in bf16 (495 TF32, 67 float32 outside the tensor
# cores).
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

# torch.cuda.get_device_name -> peak HBM bytes/s per card. The same data
# sheet and part: 80 GB of HBM3 at 3.35 TB/s.
_PEAK_HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _device_name(device) -> Optional[str]:
    """The card's name for a CUDA device (a torch.device, its string or
    index), or None for the CPU, no card or an unusable device."""
    if device is None:
        return None
    try:
        import torch

        dev = torch.device(device) if not isinstance(device, int) \
            else torch.device("cuda", device)
        if dev.type != "cuda":
            return None
        return torch.cuda.get_device_name(dev)
    except (RuntimeError, AssertionError, ValueError, TypeError):
        return None


def chip_peak_flops(device) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a CUDA device, or None if unknown (CPU)."""
    return _PEAK_BF16.get(_device_name(device))


def chip_peak_hbm_bw(device) -> Optional[float]:
    """Peak HBM bytes/s of a CUDA device, or None if unknown (CPU)."""
    return _PEAK_HBM_BW.get(_device_name(device))


# ---------------------------------------------------------------------------
# The census


def fork(obj: Any) -> Any:
    """A deep copy of an argument tree that shares no tensor, module or
    generator with ``obj``: tensors are cloned, modules deep-copied,
    generators rebuilt at the same state, and dataclasses, named tuples,
    tuples, lists and dicts copied through. Running a program on the copy
    leaves the original bit-equal."""
    import torch

    if isinstance(obj, torch.Generator):
        g = torch.Generator(device=obj.device)
        g.set_state(obj.get_state())
        return g
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone().requires_grad_(obj.requires_grad)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: fork(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(fork(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(fork(x) for x in obj)
    if isinstance(obj, dict):
        return {k: fork(v) for k, v in obj.items()}
    return obj


def _counter():
    """A dispatch mode that sums the FLOPs (``.flops``, by
    ``torch.utils.flop_counter``'s formulas) and the operand and result
    bytes (``.bytes``) of every aten op it sees. Views and detaches move
    nothing and add no bytes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not (func.is_view or func is torch.ops.aten.detach.default):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out

    # Set after the class body: a ``__torch_dispatch__`` defined in it is
    # wrapped in ``torch._disable_dynamo``, whose first call imports
    # torch._dynamo (9.7 s on the card's machine) for a census that
    # compiles nothing.
    Counter.__torch_dispatch__ = dispatch
    return Counter()


def census(fn, *args, **kwargs) -> Dict[str, Optional[float]]:
    """``{"flops", "bytes"}`` of one execution of ``fn(*args, **kwargs)``,
    run once on :func:`fork` copies of the arguments.

    This replaces JAX's ``compiled_flops``/``compiled_bytes``, and counts
    otherwise in two ways:

      * it executes what it counts, so a loop counts every trip. XLA's
        census counts a ``lax.scan`` body once whatever its trip count,
        so JAX's figure for a scanned program is about one iteration's;
      * bytes are the unfused sum of every aten op's operands and results
        (each intermediate written by one op and read by the next), so
        they sit above XLA's post-fusion "bytes accessed" of the same
        program: an upper bound on HBM traffic, not a hardware counter.

    The copies and the run are off the hot path and cost one execution of
    ``fn`` on the arguments' device. Any failure gives ``None``s."""
    try:
        args, kwargs = fork(args), fork(kwargs)
        with _counter() as count:
            fn(*args, **kwargs)
        total, moved = float(count.flops), float(count.bytes)
    except Exception:  # noqa: BLE001 — the census degrades, never raises
        return {"flops": None, "bytes": None}
    return {"flops": total if total > 0 else None,
            "bytes": moved if moved > 0 else None}


def scaled_sum(parts) -> Dict[str, Optional[float]]:
    """The cost of a program made of ``(count, cost)`` parts: the sum of
    count x cost for each key, ``None`` where any part's is unknown."""
    out: Dict[str, Optional[float]] = {}
    for key in ("flops", "bytes"):
        vals = [(n, c.get(key)) for n, c in parts]
        out[key] = (None if any(v is None for _, v in vals)
                    else float(sum(n * v for n, v in vals)))
    return out


def stratified_sample_cost(rows: int, lanes: int, samples: int,
                           members: int = 1) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one stratified draw of ``samples`` picks
    from a ``[members,] rows x lanes`` f32 mass plane, from its shapes (the
    kernel is bound through ctypes and cannot run under :func:`census`):
    read the plane and the uniforms once, write the three [S] outputs and
    the total once; add every cell once, scan the row sums, and per pick
    search log2(rows) rows and walk the lanes. The bound ``chip_smoke.py``
    prints for the kernel is this count over the card's rates."""
    bytes_moved = members * (rows * lanes * 4 + samples * 4
                             + samples * 12 + 4)
    ops = members * (rows * lanes + rows + samples * (
        math.ceil(math.log2(max(rows, 2))) + lanes))
    return {"flops": float(ops), "bytes": float(bytes_moved)}


# ---------------------------------------------------------------------------
# Roofline and MFU


def roofline_fields(flops_per_exec: Optional[float],
                    bytes_per_exec: Optional[float], device) -> dict:
    """Roofline verdict for one program execution: which bound governs,
    and the predicted step time under peak compute / peak bandwidth.

    Returns {} when any input is unknown. ``roofline_s`` is
    max(flops/peak_flops, bytes/peak_bw); measured time far above it
    means dispatch/latency overhead, near it means the named bound is
    real, and the ``roofline_bound`` field says which ceiling the
    program sits under.
    """
    peak_f = chip_peak_flops(device)
    peak_b = chip_peak_hbm_bw(device)
    if None in (flops_per_exec, bytes_per_exec, peak_f, peak_b):
        return {}
    t_compute = flops_per_exec / peak_f
    t_memory = bytes_per_exec / peak_b
    t_roof = max(t_compute, t_memory)
    return {
        "bytes_per_step": round(bytes_per_exec, 1),
        "arith_intensity": round(flops_per_exec / bytes_per_exec, 2),
        "roofline_compute_s": round(t_compute, 6),
        "roofline_memory_s": round(t_memory, 6),
        "roofline_s": round(t_roof, 6),
        "roofline_bound": "memory" if t_memory >= t_compute else "compute",
        "roofline_grad_steps_per_sec": round(1.0 / t_roof, 1),
    }


def mfu(flops_per_sec: Optional[float], device) -> Optional[float]:
    """Achieved-FLOP/s / chip-peak, or None when either side is unknown."""
    peak = chip_peak_flops(device)
    if peak is None or flops_per_sec is None:
        return None
    return flops_per_sec / peak


def nature_cnn_fwd_flops(batch: float, hidden: int = 512,
                         num_actions: int = 0) -> float:
    """Analytic forward FLOPs (2*MACs) of the Nature CNN torso on 84x84x4
    frames: VALID convs 8x8/4, 4x4/2, 3x3/1, then the fc to ``hidden``.
    ``num_actions`` > 0 adds the Q head (the recurrent net's head hangs
    off the LSTM instead — pass 0 there). Cross-checked against the
    census in tests/test_torch_flops.py."""
    macs = (20 * 20 * 8 * 8 * 4 * 32        # conv1 -> [20,20,32]
            + 9 * 9 * 4 * 4 * 32 * 64       # conv2 -> [9,9,64]
            + 7 * 7 * 3 * 3 * 64 * 64       # conv3 -> [7,7,64]
            + 3136 * hidden                 # fc
            + hidden * num_actions)         # head (feedforward nets only)
    return 2.0 * macs * batch


def lstm_cell_fwd_flops(batch: float, features: int, hidden: int) -> float:
    """Analytic forward FLOPs of one LSTM cell step: the [B, F+H] x
    [F+H, 4H] gate matmul, 2 FLOPs per MAC (elementwise gate math is
    noise next to it)."""
    return 2.0 * batch * (features + hidden) * 4.0 * hidden


def r2d2_grad_step_flops(T: int, B: int, *, hidden: int = 512,
                         lstm: int = 512, remat: bool = True) -> dict:
    """Analytic FLOPs of one R2D2 grad step (agents/r2d2.py), split into
    the terms the throughput knobs act on.

    Accounting (matches the program structure in models/recurrent.py —
    the torso embeds all T*B frames in ONE batched conv outside the time
    loop; only the cell recurrence steps through time):
      torso: online fwd + target fwd + backward (~2x fwd) over T*B frames,
             plus one recompute fwd under remat;
      cell:  online fwd + target fwd + backward (~2x fwd) over T steps.
    """
    frames = float(T) * B
    torso_passes = 4.0 + (1.0 if remat else 0.0)
    torso = torso_passes * nature_cnn_fwd_flops(frames, hidden=hidden)
    cell = 4.0 * lstm_cell_fwd_flops(frames, hidden, lstm)
    return {"torso": torso, "cell": cell, "total": torso + cell}


def r2d2_time_model(T: int, B: int, *, hidden: int = 512, lstm: int = 512,
                    remat: bool = True, lstm_bf16: bool = False,
                    unroll: int = 1, peak_bf16: Optional[float] = None,
                    f32_matmul_slowdown: float = 2.0,
                    scan_iter_overhead_s: float = 2e-6) -> dict:
    """Modeled seconds per R2D2 grad step as a function of the three
    throughput knobs.

    Terms: torso FLOPs at the bf16 peak (the torso always computes in
    ``compute_dtype`` bf16); cell FLOPs at the bf16 peak or at peak /
    ``f32_matmul_slowdown``; plus per-time-step overhead for the three
    time loops (online fwd, target fwd, backward), each ceil(T/unroll)
    iterations. ``remat`` adds torso FLOPs — it is a memory knob, modeled
    here only on the FLOPs side.

    ``peak_bf16`` defaults to the H100's dense bf16 peak (989.4 TFLOP/s).
    On Hopper an f32 matmul runs on the tensor cores as TF32 where
    ``torch.backends.cuda.matmul.allow_tf32`` allows it (495 TFLOP/s dense,
    half the bf16 rate: the default slowdown of 2) and otherwise as FFMA
    outside them (67 TFLOP/s, a slowdown of about 15)."""
    f = r2d2_grad_step_flops(T, B, hidden=hidden, lstm=lstm, remat=remat)
    if peak_bf16 is None:
        peak_bf16 = _PEAK_BF16["NVIDIA H100 80GB HBM3"]
    cell_rate = peak_bf16 if lstm_bf16 else peak_bf16 / f32_matmul_slowdown
    iters = math.ceil(T / max(unroll, 1))
    overhead = 3.0 * iters * scan_iter_overhead_s
    torso_s = f["torso"] / peak_bf16
    cell_s = f["cell"] / cell_rate
    return {"torso_s": torso_s, "cell_s": cell_s, "scan_overhead_s": overhead,
            "total_s": torso_s + cell_s + overhead,
            "modeled_grad_steps_per_sec":
                1.0 / (torso_s + cell_s + overhead)}


def mfu_fields(flops_per_exec: Optional[float], execs: int, dt: float,
               device) -> dict:
    """The benchmark-JSON fields derived from a timed run of a program:
    {} when FLOPs are unavailable, model_flops_per_sec always otherwise,
    mfu only when the chip peak is known."""
    if flops_per_exec is None or dt <= 0:
        return {}
    flops_per_sec = flops_per_exec * execs / dt
    out = {"model_flops_per_sec": round(flops_per_sec, 1)}
    m = mfu(flops_per_sec, device)
    if m is not None:
        out["mfu"] = round(m, 4)
    return out
