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
    in torch ops. ``kernel_stratified_sample.launches`` counts launches,
    and :func:`launch_geometry` gives the kernel's grid (one launch: G
    blocks that each scan a chunk of R rows, and P blocks that draw, per
    member), on its narrow path or, from ``SAMPLER_WIDE_MIN_LANES`` lanes
    on, its wide-row path. A population draws its M planes ``[M, T, B]``
    in one launch, the twin of the JAX package's vmapped ``pallas_call``.
  * :func:`stratified_sample_rows` (``:200``), the three-level draw over
    block sums that the host-replay device plane uses below the kernel's
    crossover, and :func:`importance_weights` (``:250``).
  * :func:`fixed_order_cumsum`, the blocked scan both torch draws use, so
    a draw repeats on the card.

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
from typing import Dict, NamedTuple, Optional, Tuple

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "stratified_sample.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dist_dqn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# Mirrors kThreads, kMaxChunks and kWideMinLanes in
# csrc/stratified_sample.cu: planes of at least SAMPLER_WIDE_MIN_LANES
# lanes take the kernel's wide-row path (one warp per row and per sample).
SAMPLER_THREADS = 256
SAMPLER_MAX_CHUNKS = 2048
SAMPLER_WIDE_MIN_LANES = 128
# Samples per draw block: few enough that a block's scattered loads wait
# on latency, not on its SM's load unit; the wide path's one per warp.
SAMPLER_DRAW_SAMPLES = 32
SAMPLER_WIDE_DRAW_SAMPLES = SAMPLER_THREADS // 32
# The wide path's chunks hold about as many cells as the narrow path's at
# the apex shape (256 rows of 16 lanes), but are small enough that at
# least SAMPLER_MIN_CHUNK_BLOCKS chunk blocks scan (the H100's SMs), where
# T allows.
SAMPLER_CHUNK_CELLS = 4096
SAMPLER_MIN_CHUNK_BLOCKS = 132

Samples = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# --------------------------------------------------------------------------
# The plain PyTorch version (CPU tensors, tests, and the on-card reference).
# --------------------------------------------------------------------------

def plain_stratified_sample(w: torch.Tensor, u: torch.Tensor) -> Samples:
    """The kernel's function in torch ops, phase by phase, accumulating in
    f64 as the kernel does (csrc/stratified_sample.cu says why).

    Args: ``w`` [T, B] f32 >= 0, ``u`` [S] f32 in [0, 1). Returns
    (t_idx [S] int32, b_idx [S] int32, mass_sel [S] f32, total [] f32).
    With a member axis, ``w`` [M, T, B] and ``u`` [M, S] give [M, S]
    outputs and total [M], member m's the draw from plane m alone.
    """
    if w.dim() == 2:
        return tuple(x[0] for x in _plain_members(w[None], u[None]))
    return _plain_members(w, u)


def _plain_members(w: torch.Tensor, u: torch.Tensor) -> Samples:
    """:func:`plain_stratified_sample` of [M, T, B] planes."""
    M, T, B = w.shape
    gather = torch.gather
    w64 = w.double()
    # Phase 1: row masses; the row CDF and the total.
    rs = w64.sum(dim=2)                                   # [M, T]
    cdf = torch.cumsum(rs, dim=1)
    total = cdf[:, -1]
    # Phase 2: row = #(row CDF < target), and the CDF mass before it.
    targets = u.double() * total[:, None] * (1.0 - 1e-5)  # [M, S]
    count = torch.searchsorted(cdf, targets)
    zero = torch.zeros((), dtype=torch.float64, device=w.device)
    prev = torch.where(count > 0, gather(cdf, 1, (count - 1).clamp(min=0)),
                       zero)
    t = count.clamp(max=T - 1)
    # A pick on a zero-mass row (only through rounding of the CDF) moves to
    # the nearest row with mass after it, else before it — as the kernel.
    rows = torch.arange(T, device=w.device)
    has_mass = rs > 0
    next_mass = torch.where(has_mass, rows, T).flip(1).cummin(1).values.flip(1)
    prev_mass = torch.where(has_mass, rows, -1).cummax(1).values
    next_t = gather(next_mass, 1, t)
    moved = torch.where(next_t < T, next_t, gather(prev_mass, 1, t))
    fix = ~gather(has_mass, 1, t) & (moved >= 0)
    t = torch.where(fix, moved, t)
    prev = torch.where(fix, torch.where(
        t > 0, gather(cdf, 1, (t - 1).clamp(min=0)), zero), prev)
    # Phase 3: gather the selected rows.
    members = torch.arange(M, device=w.device)[:, None]
    sel = w[members, t]                                   # [M, S, B] f32
    # Phase 4: lane = first lane with mass whose in-order cumulative mass
    # reaches the residual, clamped strictly inside the row's own mass.
    row_cum = torch.cumsum(sel.double(), dim=2)
    residual = torch.minimum(targets - prev, gather(rs, 1, t) * (1.0 - 1e-6))
    hit = (row_cum >= residual[..., None]) & (sel > 0)
    lanes = torch.arange(B, device=w.device)
    last = torch.where(sel > 0, lanes, -1).amax(dim=2)
    last = torch.where(last >= 0, last, B - 1)
    b = torch.where(hit.any(dim=2), hit.int().argmax(dim=2), last)
    mass = sel.gather(2, b[..., None])[..., 0]
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
                ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, ptr, ptr,
                ptr, ptr, ptr, ptr, ptr]
            lib.dqn_stratified_sample.restype = i32
            for name in ("dqn_stratified_sample_static_smem",
                         "dqn_stratified_sample_wide_min_lanes"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i32
            lib.dqn_cuda_error_string.argtypes = [i32]
            lib.dqn_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_inputs(w: torch.Tensor, u: torch.Tensor) -> None:
    if not ((w.dim() == 2 and u.dim() == 1) or
            (w.dim() == 3 and u.dim() == 2 and u.shape[0] == w.shape[0])):
        raise ValueError(f"expected w [T, B] and u [S], or w [M, T, B] and "
                         f"u [M, S], got {tuple(w.shape)} and "
                         f"{tuple(u.shape)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"expected float32 w and u, got {w.dtype}, {u.dtype}")
    if u.device != w.device:
        raise ValueError(f"w on {w.device} but u on {u.device}")
    if min(w.shape) == 0 or min(u.shape) == 0:
        raise ValueError("empty mass plane or sample batch")
    if max(*w.shape, u.numel()) >= 2 ** 31:
        raise ValueError("dimension too large for the kernel's int32 sizes")


class LaunchGeometry(NamedTuple):
    """How the kernel cuts a draw of S samples from each of M [T, B]
    planes: one launch of M·(G + P) blocks of ``threads`` threads, per
    member ``chunks`` (G) blocks that each scan ``rows_per_chunk`` (R)
    consecutive rows, with G·R >= T > (G−1)·R, and ``draw_blocks`` (P)
    blocks that draw the samples; on the wide-row path where ``wide``."""
    rows_per_chunk: int
    chunks: int
    draw_blocks: int
    threads: int
    scratch_f64: int          # per member: row sums [T], local CDF [T],
    #                           totals [G]
    static_smem_bytes: int    # the kernel's `Shared` struct
    sync_words: int           # ticket counter, M done and M drawn counts
    wide: bool                # one warp per row and per sample


def launch_geometry(T: int, S: int = 1, members: int = 1, *, B: int,
                    wide: Optional[bool] = None) -> LaunchGeometry:
    """The kernel's grid for ``T`` rows of ``B`` lanes and ``S`` samples of
    each of ``members`` planes. ``wide`` is None for the kernel's own
    choice, the wide-row path from ``SAMPLER_WIDE_MIN_LANES`` lanes on
    (``chip_smoke.py``'s width sweep forces each path to time both).

    The narrow path: chunks of one tile of ``SAMPLER_THREADS`` rows each
    (G = 245 at the apex preset's T=62,500, so every SM scans one), grown
    by whole tiles only where T needs more than ``SAMPLER_MAX_CHUNKS``
    chunks, which is as many chunk offsets as a block's shared memory
    holds; and one draw block per ``SAMPLER_DRAW_SAMPLES`` samples. The
    wide path: chunks of ``SAMPLER_CHUNK_CELLS`` cells in whole rows, cut
    to fewer rows where that leaves fewer than
    ``SAMPLER_MIN_CHUNK_BLOCKS`` chunks and T allows more (R = 8 and
    G = 245 at [1954, 512], R = 7 and G = 140 at [977, 512]), grown where
    T needs more than ``SAMPLER_MAX_CHUNKS``; one draw block per
    ``SAMPLER_WIDE_DRAW_SAMPLES`` samples."""
    if wide is None:
        wide = B >= SAMPLER_WIDE_MIN_LANES
    warps = SAMPLER_THREADS // 32
    if wide:
        rows = max(1, min(SAMPLER_CHUNK_CELLS // B,
                          T // SAMPLER_MIN_CHUNK_BLOCKS),
                   -(-T // SAMPLER_MAX_CHUNKS))
        per_block = SAMPLER_WIDE_DRAW_SAMPLES
    else:
        tiles = -(-T // SAMPLER_THREADS)
        rows = SAMPLER_THREADS * -(-tiles // SAMPLER_MAX_CHUNKS)
        per_block = SAMPLER_DRAW_SAMPLES
    chunks = -(-T // rows)
    draws = -(-S // per_block)
    # double offset[max_chunks + 1] (a union with the wide path's
    # double rows[threads]); double warp[warps]; u32 ticket (padded).
    smem = 8 * (SAMPLER_MAX_CHUNKS + 1 + warps + 1)
    return LaunchGeometry(rows, chunks, draws, SAMPLER_THREADS,
                          members * (2 * T + chunks), smem, 1 + 2 * members,
                          wide)


# Per card: the kernel's sync words (u32 it leaves at zero: 1 + 2·M)
# and its scratch, allocated once and grown as M·T grows. One pair serves
# one stream at a time, which is how the port draws.
_workspaces: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, geo: LaunchGeometry
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = _workspaces.get(device.index)
    if (ws is None or ws[0].numel() < geo.sync_words
            or ws[1].numel() < geo.scratch_f64):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the sampler kernel's workspace is allocated outside CUDA "
                "graph capture: make one eager call at this shape (or a "
                "larger one) before capturing")
        # Sync words only ever hold zero between launches, so fresh zeros
        # take the place of the old ones.
        sync = (ws[0] if ws is not None and ws[0].numel() >= geo.sync_words
                else torch.zeros(geo.sync_words, dtype=torch.int32,
                                 device=device))
        scratch = (ws[1] if ws is not None
                   and ws[1].numel() >= geo.scratch_f64 else
                   torch.empty(geo.scratch_f64, dtype=torch.float64,
                               device=device))
        ws = _workspaces[device.index] = (sync, scratch)
    return ws


def kernel_stratified_sample(w: torch.Tensor, u: torch.Tensor) -> Samples:
    """Draw ``u.shape[-1]`` samples ~ ``w`` (a [T, B] non-negative f32 mass
    plane) at stratified uniforms ``u`` [S] in [0, 1).

    Returns (t_idx [S] int32, b_idx [S] int32, mass_sel [S] f32,
    total [] f32), views of one fresh buffer. With a member axis, ``w``
    [M, T, B] and ``u`` [M, S], one launch draws every member's samples:
    [M, S] outputs and total [M], member m's bit for bit those of a launch
    on plane m alone (the 2-D call is the M = 1 launch). A CUDA tensor
    launches the Hopper kernel on the current stream (no synchronisation)
    and raises if the launch fails; a CPU tensor runs
    :func:`plain_stratified_sample`. ``launches`` counts each launch, one
    per call on the card whatever M, and nothing on the CPU.
    """
    _check_inputs(w, u)
    device = w.device
    if device.type == "cpu":
        return plain_stratified_sample(w, u)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("the kernel takes contiguous w and u")
    if device.index != torch.cuda.current_device():
        # The kernel launches on the current card.
        with torch.cuda.device(device):
            return kernel_stratified_sample(w, u)
    stacked = w.dim() == 3
    M, T, B = w.shape if stacked else (1, *w.shape)
    S = u.shape[-1]
    t_idx, b_idx, mass, total = _launch(w, u, launch_geometry(T, S, M, B=B))
    if not stacked:
        return t_idx, b_idx, mass, total[0]
    return (t_idx.view(M, S), b_idx.view(M, S), mass.view(M, S), total)


def _launch(w: torch.Tensor, u: torch.Tensor,
            geo: LaunchGeometry) -> Samples:
    """One launch of the kernel at ``geo`` on contiguous [M, T, B] planes
    (or one [T, B] plane) and their uniforms, on the current card and
    stream: t_idx, b_idx and mass_sel [M·S] and total [M], views of one
    fresh buffer. Counts the launch."""
    lib = _load()
    M, T, B = w.shape if w.dim() == 3 else (1, *w.shape)
    S = u.shape[-1]
    device = w.device
    sync, scratch = _workspace(device, geo)
    # t_idx [M, S] | b_idx [M, S] | mass [M, S] | total [M], 4 bytes each.
    n = M * S
    out = torch.empty(3 * n + M, dtype=torch.int32, device=device)
    base = out.data_ptr()
    # The current stream's handle: torch.cuda.current_stream() would build
    # a Stream object on every call, which costs about as much host time
    # as the launch itself.
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = lib.dqn_stratified_sample(
        w.data_ptr(), u.data_ptr(), M, T, B, S, geo.rows_per_chunk,
        geo.chunks, geo.draw_blocks, int(geo.wide), scratch.data_ptr(),
        sync.data_ptr(), base, base + 4 * n, base + 8 * n, base + 12 * n,
        stream)
    if err != 0:
        raise RuntimeError("stratified sample kernel launch failed: "
                           + lib.dqn_cuda_error_string(err).decode())
    kernel_stratified_sample.launches += 1
    t_idx, b_idx, rest = out.split([n, n, n + M])
    values = rest.view(torch.float32)
    return t_idx, b_idx, values[:n], values[n:]


kernel_stratified_sample.launches = 0


# --------------------------------------------------------------------------
# The draw both replay samplers share.
# --------------------------------------------------------------------------

# Elements per block of :func:`fixed_order_cumsum`: 1M cells make 977
# blocks, whose totals one short scan covers.
SCAN_BLOCK = 1024


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last dim whose order of additions is fixed
    by the shape, not by the card's scheduling.

    ``torch.cumsum`` of one long row on the card runs a single-pass scan
    whose partial sums combine in whatever order its blocks finish, so
    the same 200,000 floats can sum differently between two calls. Here
    the row is padded to ``[R, SCAN_BLOCK]`` blocks, each block is scanned
    along its own row (one block of threads per row, a fixed tree), and
    the exclusive scan of the R block totals is added back. A row of at
    most SCAN_BLOCK elements is scanned as ``torch.cumsum`` scans it."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return torch.cumsum(x, dim=-1)
    lead = x.shape[:-1]
    rows = -(-n // SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, rows * SCAN_BLOCK - n)).reshape(
        lead + (rows, SCAN_BLOCK))
    inner = torch.cumsum(blocks, dim=-1)
    totals = inner[..., -1]
    offsets = torch.cumsum(totals, dim=-1) - totals
    return (inner + offsets[..., None]).reshape(
        lead + (rows * SCAN_BLOCK,))[..., :n]


SAMPLE_BLOCK = 32  # lanes per second-level block of the hierarchical draw


def stratified_sample_rows(w: torch.Tensor, blk_sums: torch.Tensor,
                           u: torch.Tensor) -> Samples:
    """Three-level inverse-CDF draw at explicit uniforms ``u`` [S] (twin of
    ``stratified_sample_rows``, dist_dqn_tpu/ops/pallas_sampler.py:200):
    the row by the [T] row-sum CDF (row sums reduced from ``blk_sums``
    [T, NB], the per-``SAMPLE_BLOCK`` partial sums of ``w`` its owner keeps
    up to date), then the block by the selected rows' [NB] block sums,
    then the lane inside one block. Each level's residual is clamped
    strictly inside its own mass, since the levels reduce in different
    orders. Same (t_idx, b_idx, mass_sel, total) contract as
    :func:`stratified_sample_at`; the row scan is
    :func:`fixed_order_cumsum`."""
    T, B = w.shape
    NB = blk_sums.shape[1]
    BS = B // NB
    row_sums = blk_sums.sum(dim=1)
    cdf = fixed_order_cumsum(row_sums)
    total = cdf[-1]
    pos = u.float() * total
    t_idx = torch.searchsorted(cdf, pos).clamp(0, T - 1)
    blk = blk_sums[t_idx]                                   # [S, NB]
    blk_cdf = torch.cumsum(blk, dim=1)
    res = torch.minimum(pos - (cdf[t_idx] - row_sums[t_idx]),
                        blk_cdf[:, -1] * (1.0 - 1e-6))[:, None]
    jb = (blk_cdf < res).int().sum(dim=1, keepdim=True).clamp(
        max=NB - 1).long()                                  # [S, 1]
    res2 = res - (blk_cdf.gather(1, jb) - blk.gather(1, jb))
    sub = w.reshape(T, NB, BS)[t_idx, jb[:, 0]]             # [S, BS]
    sub_cdf = torch.cumsum(sub, dim=1)
    res2 = torch.minimum(res2, sub_cdf[:, -1:] * (1.0 - 1e-6))
    b2 = (sub_cdf < res2).int().sum(dim=1, keepdim=True).clamp(
        max=BS - 1).long()                                  # [S, 1]
    mass = sub.gather(1, b2)[:, 0]
    b_idx = jb[:, 0] * BS + b2[:, 0]
    return t_idx.int(), b_idx.int(), mass, total


def stratified_uniforms(generator, batch_size: int, device) -> torch.Tensor:
    """One uniform per stratum: (i + U[0, 1)) / S for i < S. ``generator``
    may be a list of M member generators: each draws its solo [S] jitter,
    and the result is [M, S]."""
    if isinstance(generator, (list, tuple)):
        jitter = torch.stack([torch.rand(batch_size, generator=g,
                                         device=device) for g in generator])
    else:
        jitter = torch.rand(batch_size, generator=generator, device=device)
    return (torch.arange(batch_size, dtype=torch.float32, device=device)
            + jitter) / batch_size


def stratified_sample(w: torch.Tensor, generator, batch_size: int,
                      use_kernel: bool = False) -> Samples:
    """Stratified inverse-CDF draw from a [T, B] mass plane. Returns
    (t_idx [S], b_idx [S], mass_sel [S], total []); from M planes [M, T, B]
    with a list of M member generators, [M, S] outputs and total [M]."""
    u01 = stratified_uniforms(generator, batch_size, w.device)
    return stratified_sample_at(w, u01, use_kernel=use_kernel)


def stratified_sample_at(w: torch.Tensor, u: torch.Tensor,
                         use_kernel: bool = False) -> Samples:
    """Inverse-CDF draw from a [T, B] mass plane at EXPLICIT uniforms ``u``
    [S] in [0, 1) (or from [M, T, B] planes at [M, S] uniforms, each member
    on its own plane). ``use_kernel`` routes through
    :func:`kernel_stratified_sample`; otherwise the flat cumsum +
    searchsorted twin of the JAX package's XLA path, its scan of fixed
    order (:func:`fixed_order_cumsum`)."""
    if use_kernel:
        return kernel_stratified_sample(w, u)
    if w.dim() == 2:
        return tuple(x[0] for x in stratified_sample_at(w[None], u[None]))
    num_envs = w.shape[-1]
    flat = w.reshape(w.shape[0], -1)
    cdf = fixed_order_cumsum(flat)
    total = cdf[:, -1]
    idx = torch.searchsorted(cdf, u * total[:, None]).clamp(
        0, flat.shape[1] - 1)
    return ((idx // num_envs).int(), (idx % num_envs).int(),
            flat.gather(1, idx), total)


def importance_weights(mass_sel: torch.Tensor, total: torch.Tensor,
                       n_valid: torch.Tensor, beta: float) -> torch.Tensor:
    """(N * P(i))^-beta, batch-max normalized; zero-mass selections get
    weight 0 instead of an enormous one that would crush the batch. With a
    member axis (mass_sel [M, S], total [M]) each member's batch is
    normalized by its own max."""
    if mass_sel.dim() == 1:
        return importance_weights(mass_sel[None], total[None], n_valid,
                                  beta)[0]
    p_sel = mass_sel.clamp(min=1e-12) / total[:, None].clamp(min=1e-12)
    weights = (n_valid.clamp(min=1.0) * p_sel) ** (-beta)
    weights = torch.where(mass_sel > 0.0, weights, torch.zeros_like(weights))
    return weights / weights.amax(dim=1, keepdim=True).clamp(min=1e-12)
