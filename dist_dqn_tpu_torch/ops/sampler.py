"""Stratified inverse-CDF priority sampling: the CUDA kernel, its plain
PyTorch version, and the routing around them.

Counterpart of ``dist_dqn_tpu/ops/pallas_sampler.py``:

  * :func:`stratified_sample` / :func:`stratified_sample_at` (``:157-194``)
    — the one draw both replay samplers share. With ``use_kernel`` the draw
    goes through :func:`kernel_stratified_sample`; otherwise through the
    torch twin of the JAX package's cumsum+searchsorted path.
  * :func:`kernel_stratified_sample` — the wrapper of the hand-written
    Hopper kernel (``csrc/stratified_sample.cu``), which replaces the TPU
    kernel ``_sample_kernel`` / ``pallas_stratified_sample``. On a CUDA
    tensor it launches the kernel or raises; on a CPU tensor, and only
    there, it runs :func:`plain_stratified_sample`, the same four phases
    in torch ops. ``kernel_stratified_sample.launches`` counts launches.
  * :func:`importance_weights` (``:250``).

The kernel is compiled with ``nvcc`` into ``build/dist_dqn_tpu_torch/`` at
its first use and loaded with ``ctypes`` (:func:`build_library`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "stratified_sample.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dist_dqn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

Samples = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# --------------------------------------------------------------------------
# The plain PyTorch version (CPU tensors, tests, and the on-card reference).
# --------------------------------------------------------------------------

def plain_stratified_sample(w: torch.Tensor, u: torch.Tensor) -> Samples:
    """The kernel's function in torch ops, phase by phase, accumulating in
    f64 as the kernel does (csrc/stratified_sample.cu says why).

    Args: ``w`` [T, B] f32 >= 0, ``u`` [S] f32 in [0, 1). Returns
    (t_idx [S] int32, b_idx [S] int32, mass_sel [S] f32, total [] f32).
    """
    T, B = w.shape
    w64 = w.double()
    # Phase 1: row masses; the row CDF and the total.
    rs = w64.sum(dim=1)
    cdf = torch.cumsum(rs, dim=0)
    total = cdf[-1]
    # Phase 2: row = #(row CDF < target), and the CDF mass before it.
    targets = u.double() * total * (1.0 - 1e-5)
    count = torch.searchsorted(cdf, targets)
    zero = torch.zeros((), dtype=torch.float64, device=w.device)
    prev = torch.where(count > 0, cdf[(count - 1).clamp(min=0)], zero)
    t = count.clamp(max=T - 1)
    # A pick on a zero-mass row (only through rounding of the CDF) moves to
    # the nearest row with mass after it, else before it — as the kernel.
    rows = torch.arange(T, device=w.device)
    has_mass = rs > 0
    next_mass = torch.where(has_mass, rows, T).flip(0).cummin(0).values.flip(0)
    prev_mass = torch.where(has_mass, rows, -1).cummax(0).values
    moved = torch.where(next_mass[t] < T, next_mass[t], prev_mass[t])
    fix = ~has_mass[t] & (moved >= 0)
    t = torch.where(fix, moved, t)
    prev = torch.where(fix, torch.where(t > 0, cdf[(t - 1).clamp(min=0)],
                                        zero), prev)
    # Phase 3: gather the selected rows.
    sel = w[t]                                            # [S, B] f32
    # Phase 4: lane = first lane with mass whose in-order cumulative mass
    # reaches the residual, clamped strictly inside the row's own mass.
    row_cum = torch.cumsum(sel.double(), dim=1)
    residual = torch.minimum(targets - prev, rs[t] * (1.0 - 1e-6))
    hit = (row_cum >= residual[:, None]) & (sel > 0)
    lanes = torch.arange(B, device=w.device)
    last = torch.where(sel > 0, lanes, -1).amax(dim=1)
    last = torch.where(last >= 0, last, B - 1)
    b = torch.where(hit.any(dim=1), hit.int().argmax(dim=1), last)
    mass = sel.gather(1, b[:, None])[:, 0]
    return t.int(), b.int(), mass, total.float()


# --------------------------------------------------------------------------
# The CUDA kernel: build, load, launch.
# --------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the sampler "
                       "kernel is built from csrc/ at first use")


def library_path() -> Path:
    """Where the built library lives: named by a hash of the source and
    the flags, so an edited source never loads a stale build."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libstratified_sample_{digest}.so"


def build_library() -> Path:
    """Compile ``csrc/stratified_sample.cu`` for sm_90a unless this
    source's build exists; returns the library path. Raises with the
    compiler's output when nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.dqn_stratified_sample.argtypes = [
                ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
            lib.dqn_stratified_sample.restype = i32
            lib.dqn_cuda_error_string.argtypes = [i32]
            lib.dqn_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_inputs(w: torch.Tensor, u: torch.Tensor) -> None:
    if w.dim() != 2 or u.dim() != 1:
        raise ValueError(f"expected w [T, B] and u [S], got {tuple(w.shape)} "
                         f"and {tuple(u.shape)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"expected float32 w and u, got {w.dtype}, {u.dtype}")
    if u.device != w.device:
        raise ValueError(f"w on {w.device} but u on {u.device}")
    if min(w.shape) == 0 or u.shape[0] == 0:
        raise ValueError("empty mass plane or sample batch")
    if max(w.shape[0], w.shape[1], u.shape[0]) >= 2 ** 31:
        raise ValueError("dimension too large for the kernel's int32 sizes")


def kernel_stratified_sample(w: torch.Tensor, u: torch.Tensor) -> Samples:
    """Draw ``u.shape[0]`` samples ~ ``w`` (a [T, B] non-negative f32 mass
    plane) at stratified uniforms ``u`` [S] in [0, 1).

    Returns (t_idx [S] int32, b_idx [S] int32, mass_sel [S] f32,
    total [] f32). A CUDA tensor launches the Hopper kernel on the current
    stream (no synchronisation) and raises if the launch fails; a CPU
    tensor runs :func:`plain_stratified_sample`.
    """
    _check_inputs(w, u)
    if w.device.type == "cpu":
        return plain_stratified_sample(w, u)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("the kernel takes contiguous w and u")
    lib = _load()
    T, B = w.shape
    S = u.shape[0]
    f32 = dict(dtype=torch.float32, device=w.device)
    i32 = dict(dtype=torch.int32, device=w.device)
    # Scratch of (a) and (b). Dropping it on return while the launches may
    # still run is safe: the caching allocator hands the memory only to
    # work queued later on this same stream.
    rs = torch.empty(T, dtype=torch.float64, device=w.device)
    cdf = torch.empty(T, dtype=torch.float64, device=w.device)
    total = torch.empty((), **f32)
    t_idx = torch.empty(S, **i32)
    b_idx = torch.empty(S, **i32)
    mass = torch.empty(S, **f32)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.dqn_stratified_sample(
            w.data_ptr(), u.data_ptr(), T, B, S, rs.data_ptr(),
            cdf.data_ptr(), total.data_ptr(), t_idx.data_ptr(),
            b_idx.data_ptr(), mass.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("stratified sample kernel launch failed: "
                           + lib.dqn_cuda_error_string(err).decode())
    kernel_stratified_sample.launches += 1
    return t_idx, b_idx, mass, total


kernel_stratified_sample.launches = 0


# --------------------------------------------------------------------------
# The draw both replay samplers share.
# --------------------------------------------------------------------------

def stratified_uniforms(generator: Optional[torch.Generator],
                        batch_size: int, device) -> torch.Tensor:
    """One uniform per stratum: (i + U[0, 1)) / S for i < S."""
    jitter = torch.rand(batch_size, generator=generator, device=device)
    return (torch.arange(batch_size, dtype=torch.float32, device=device)
            + jitter) / batch_size


def stratified_sample(w: torch.Tensor, generator: Optional[torch.Generator],
                      batch_size: int, use_kernel: bool = False) -> Samples:
    """Stratified inverse-CDF draw from a [T, B] mass plane. Returns
    (t_idx [S], b_idx [S], mass_sel [S], total [])."""
    u01 = stratified_uniforms(generator, batch_size, w.device)
    return stratified_sample_at(w, u01, use_kernel=use_kernel)


def stratified_sample_at(w: torch.Tensor, u: torch.Tensor,
                         use_kernel: bool = False) -> Samples:
    """Inverse-CDF draw from a [T, B] mass plane at EXPLICIT uniforms ``u``
    [S] in [0, 1). ``use_kernel`` routes through
    :func:`kernel_stratified_sample`; otherwise the flat cumsum +
    searchsorted twin of the JAX package's XLA path."""
    if use_kernel:
        return kernel_stratified_sample(w, u)
    num_envs = w.shape[1]
    flat = w.reshape(-1)
    cdf = torch.cumsum(flat, dim=0)
    total = cdf[-1]
    idx = torch.searchsorted(cdf, u * total).clamp(0, flat.shape[0] - 1)
    return ((idx // num_envs).int(), (idx % num_envs).int(), flat[idx],
            total)


def importance_weights(mass_sel: torch.Tensor, total: torch.Tensor,
                       n_valid: torch.Tensor, beta: float) -> torch.Tensor:
    """(N * P(i))^-beta, batch-max normalized; zero-mass selections get
    weight 0 instead of an enormous one that would crush the batch."""
    p_sel = mass_sel.clamp(min=1e-12) / total.clamp(min=1e-12)
    weights = (n_valid.clamp(min=1.0) * p_sel) ** (-beta)
    weights = torch.where(mass_sel > 0.0, weights, torch.zeros_like(weights))
    return weights / weights.max().clamp(min=1e-12)
