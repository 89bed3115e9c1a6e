"""The decode kernels of the Open-Pose+, PoP-Net and COCO RGB paths: one
wrapper per CUDA kernel, with its plain PyTorch version beside it.

| wrapper          | CUDA source            | TPU kernel it replaces                   |
| ---------------- | ---------------------- | ---------------------------------------- |
| `find_peaks`     | csrc/find_peaks.cu     | pallas_kernels.py find_peaks_pallas_bt   |
| `find_peaks_row` | csrc/find_peaks.cu     | pallas_kernels.py find_peaks_pallas      |
| `find_peaks_plane` | csrc/find_peaks.cu   | both find_peaks kernels above, where K1 cannot hold the maps |
| `paf_score`      | csrc/paf_score.cu      | pallas_kernels.py paf_sample_pallas      |
| `window_readout` | csrc/readout.cu        | pallas_kernels.py window_readout_pallas  |
| `point_readout`  | csrc/readout.cu        | pallas_kernels.py point_readout_pallas   |
| `readouts`       | csrc/readout.cu        | both readouts above, in one launch       |
| `assemble_ids`   | csrc/assemble.cu       | assemble_pallas.py assemble_ids_pallas   |
| `peak_local_max` | csrc/peak_mask.cu      | pallas_kernels.py peak_local_max_pallas  |

`find_peaks`, `find_peaks_row` and `find_peaks_plane` are three designs of
one function and share one plain version, `find_peaks_plain`; where a
frame's planes do not fit one block of the first or a side exceeds 255
cells, `find_peaks` launches the third (`find_peaks_route`); the second
launches only when called by name. `readouts` is the Open-Pose+
decode's launch of K4 and K5 together, from the normalized maps: it counts
as one launch of each of the two.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel on the current stream or raises. Nothing falls back.
Each wrapper counts its kernel launches in its `launches` attribute
(`reset_launches`, `launch_counts`), so a run can show that it went
through the kernels.

The plain versions repeat the kernels' arithmetic in the same order with
unfused float32 products and sums, so kernel and plain version agree bit
for bit on the card; the CPU tests hold the plain versions against the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from popnet_tpu_torch.ops import _build

_SENT = -1e30  # finite sentinel of the peak NMS: 0 * -inf would be NaN

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_FIND_PEAKS_ARGS = [_P, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P,
                    _P, _P, _P]
_FIND_PEAKS_ROW_ARGS = _FIND_PEAKS_ARGS[:5] + [_LL] + _FIND_PEAKS_ARGS[5:]  # + readable bytes
_SIGNATURES = {
    "popnet_find_peaks": ("find_peaks", _FIND_PEAKS_ARGS),
    "popnet_find_peaks_row": ("find_peaks", _FIND_PEAKS_ROW_ARGS),
    "popnet_find_peaks_plane": ("find_peaks", _FIND_PEAKS_ARGS),
    "popnet_paf_score": ("paf_score", [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _F, _F, _F, _P, _P, _P]),
    "popnet_window_readout": ("readout", [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL,
                                          _LL, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "popnet_point_readout": ("readout", [_P, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I,
                                         _P, _P]),
    "popnet_readouts": ("readout", [_P, _LL, _LL, _LL, _LL, _I, _P, _LL, _LL, _LL, _LL,
                                    _P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P]),
    "popnet_assemble": ("assemble", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P]),
    "popnet_peak_mask": ("peak_mask", [_P, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _F, _P, _LL,
                                       _LL, _LL, _LL, _P]),
}
_consts: dict = {}
_stamped: set[str] = set()  # sources launched from their stage-clock build (stage_clocks)


def _launch(symbol: str, device: torch.device, *args) -> None:
    """Call a launcher of csrc/ on the current stream; raise on its error."""
    source, argtypes = _SIGNATURES[symbol]
    fn = getattr(_build.library(source, stamps=source in _stamped), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: CUDA error {err}")


STAMP_BLOCKS, STAMPS = 4096, 8  # csrc/common.cuh kStampBlocks, kStamps


def stage_clocks(source: str, fn) -> np.ndarray:
    """Run fn() once with the kernels of csrc/<source>.cu launched from its
    stage-clock build; return the (STAMP_BLOCKS, STAMPS) int64 clock64()
    stamps that its blocks recorded at each STAGE_STAMP (csrc/common.cuh;
    zero for blocks beyond the grid). A measurement tool: the serving paths
    never call it."""
    lib = _build.library(source, stamps=True)
    lib.popnet_stage_clocks_clear.restype = ctypes.c_int
    torch.cuda.synchronize()
    err = lib.popnet_stage_clocks_clear()
    if err != 0:
        raise RuntimeError(f"popnet_stage_clocks_clear of {source} failed: CUDA error {err}")
    _stamped.add(source)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _stamped.discard(source)
    out = np.zeros((STAMP_BLOCKS, STAMPS), np.int64)
    copy = lib.popnet_stage_clocks
    copy.argtypes, copy.restype = [_P, _I], ctypes.c_int
    err = copy(out.ctypes.data, out.size)
    if err != 0:
        raise RuntimeError(f"popnet_stage_clocks of {source} failed: CUDA error {err}")
    return out


def blocks_per_sm(source: str, *sizes: int, kernel: str | None = None) -> int:
    """Blocks of the kernel of csrc/<source>.cu (or of its `kernel`, where
    the source has two) that one SM of the current card holds at these
    sizes (find_peaks, find_peaks_row: K, H, W, M; paf_score: K, L, M, H,
    W; assemble: K, L, M, max_people)."""
    return occupancy(source, f"popnet_{kernel or source}_blocks_per_sm", *sizes)


def occupancy(source: str, symbol: str, *sizes: int) -> int:
    """What an occupancy query of csrc/<source>.cu reports at these sizes:
    `popnet_<kernel>_blocks_per_sm`, or `popnet_find_peaks_row_clusters`
    (the clusters the card places at once)."""
    fn = getattr(_build.library(source), symbol)
    fn.argtypes, fn.restype = [_I] * len(sizes) + [_P], ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(*sizes, ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return n.value


def copy_width(source: str, t: torch.Tensor, K: int = 15, M: int = 16) -> int:
    """Elements per asynchronous copy (1, 2 or 4) with which the kernel of
    csrc/<source>.cu brings a frame of `t` into shared memory: find_peaks
    (B, K, H, W) heat planes, paf_score (B, H, W, 2L) maps for K joints of
    M peaks (the width every group of limbs gets, `paf_score_groups`). 4
    where the strides leave 16-byte runs, as the depth path's PAF maps do."""
    fn = getattr(_build.library(source), f"popnet_{source}_copy_width")
    if source == "find_peaks":
        fn.argtypes, fn.restype = [_P] + [_LL] * 4 + [_I] * 3, ctypes.c_int
        _, K, H, W = t.shape
        return fn(t.data_ptr(), *t.stride(), K, H, W)
    fn.argtypes, fn.restype = [_P] + [_LL] * 4 + [_I] * 5, ctypes.c_int
    _, H, W, C = t.shape
    return fn(t.data_ptr(), *t.stride(), K, C // 2, M, H, W)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None,
           contiguous: bool = False) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True if every tensor is on a CUDA device, False if all are on the
    CPU; raises on anything else."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        if len({t.device for t in ts}) != 1:
            raise ValueError("tensors are on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on one CPU or CUDA device, got {kinds}")


def _const(key, make, device):
    """A small constant tensor kept on `device` (upsample matrix, limbs)."""
    k = (key, str(device))
    if k not in _consts:
        _consts[k] = make().to(device)
    return _consts[k]


def _limbs(limbs: tuple, device) -> torch.Tensor:
    """(L, 2) int64 limb table on `device` (kept, so no copy runs per call)."""
    return _const(("limbs_i64", tuple(limbs)), lambda: torch.tensor(limbs, dtype=torch.long),
                  device)


def _limbs_i32(limbs: tuple, device) -> torch.Tensor:
    """Flat (2L,) int32 limb table on `device`, as the kernels read it."""
    return _const(("limbs", tuple(limbs)),
                  lambda: torch.tensor(limbs, dtype=torch.int32).reshape(-1), device)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution weights (cv2 INTER_CUBIC uses a=-0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1,
        (a + 2) * t**3 - (a + 3) * t**2 + 1,
        np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
    )


def _upsample_matrix(size: int, factor: int) -> np.ndarray:
    """(size*factor, size) matrix U with cv2.resize INTER_CUBIC semantics:
    out[j] = sum_i U[j, i] * in[i], border-replicated."""
    out = np.zeros((size * factor, size))
    for j in range(size * factor):
        src = (j + 0.5) / factor - 0.5
        i0 = int(np.floor(src))
        for k in range(-1, 3):
            idx = i0 + k
            out[j, int(np.clip(idx, 0, size - 1))] += _cubic_kernel(src - idx)
    return out


def _upsample(size: int, factor: int, device) -> torch.Tensor:
    return _const(("U", size, factor),
                  lambda: torch.from_numpy(_upsample_matrix(size, factor)).float(), device)


# ---- K1: peak NMS + top-M + windowed bicubic refine -----------------------


def find_peaks_plain(heat: torch.Tensor, max_peaks: int = 16, thresh: float = 0.1,
                     factor: int = 8, win_size: int = 2):
    """Plain version of `find_peaks`. heat: (B, K, H, W) float32.

    Returns (px, py, loc, score, valid), each (B, K, max_peaks): integer
    peak coords (0 for invalid slots, which are still refined at (0, 0)),
    the flat argmax in the (S, S) refine window, its value, and validity."""
    B, K, H, W = heat.shape
    h = heat.float()
    pad = F.pad(h, (1, 1, 1, 1), value=_SENT)
    mx = torch.maximum(torch.maximum(pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]),
                       torch.maximum(pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]))
    score = torch.where((h >= mx) & (h > thresh), h, torch.full_like(h, _SENT))
    score = score.reshape(B, K, H * W)
    idxs, vals = [], []
    for _ in range(max_peaks):
        idx = score.argmax(dim=-1, keepdim=True)      # first flat index of the max
        v = score.gather(-1, idx)
        score = score.scatter(-1, idx, v - 1e30)
        idxs.append(idx)
        vals.append(v)
    idx = torch.cat(idxs, -1)
    valid = torch.cat(vals, -1) > -1e29
    px = torch.where(valid, idx % W, 0).to(torch.int32)
    py = torch.where(valid, idx // W, 0).to(torch.int32)

    size = 2 * win_size + 1
    S = size * factor
    U = _upsample(size, factor, h.device)                       # (S, size)
    offs = torch.arange(size, device=h.device) - win_size
    rows = (py[..., None].long() + offs).clamp(0, H - 1)        # (B, K, M, size)
    cols = (px[..., None].long() + offs).clamp(0, W - 1)
    bi = torch.arange(B, device=h.device)[:, None, None, None, None]
    ki = torch.arange(K, device=h.device)[None, :, None, None, None]
    patch = h[bi, ki, rows[..., :, None], cols[..., None, :]]   # (B, K, M, size, size)
    upA = U[:, 0, None] * patch[..., 0, None, :]                # (B, K, M, S, size)
    for i in range(1, size):
        upA = upA + U[:, i, None] * patch[..., i, None, :]
    up = upA[..., :, None, 0] * U[:, 0]                         # (B, K, M, S, S)
    for j in range(1, size):
        up = up + upA[..., :, None, j] * U[:, j]
    kx0 = (win_size - px).clamp(min=0)[..., None]
    kx1 = win_size + (W - 1 - px).clamp(max=win_size)[..., None]
    ky0 = (win_size - py).clamp(min=0)[..., None]
    ky1 = win_size + (H - 1 - py).clamp(max=win_size)[..., None]
    cell = torch.arange(S, device=h.device) // factor
    row_ok = (cell >= ky0) & (cell <= ky1)                      # (B, K, M, S)
    col_ok = (cell >= kx0) & (cell <= kx1)
    up = up.masked_fill(~(row_ok[..., :, None] & col_ok[..., None, :]), float("-inf"))
    up = up.reshape(B, K, max_peaks, S * S)
    loc = up.argmax(dim=-1, keepdim=True)
    peak_score = up.gather(-1, loc)[..., 0]
    return px, py, loc[..., 0].to(torch.int32), peak_score, valid


SMEM_PER_BLOCK = 227 * 1024   # the dynamic shared memory a block may have on the H100


def _find_peaks_args(heat, max_peaks, win_size, factor) -> None:
    _check(heat, "heat", torch.float32)
    if (win_size, factor) != (2, 8):
        raise ValueError(f"the find_peaks kernels refine 5x5 windows upsampled 8x (win_size=2, "
                         f"factor=8), got win_size={win_size}, factor={factor}")
    if max_peaks > 32:
        raise ValueError(f"the find_peaks kernels keep at most 32 peaks, got {max_peaks}")


@functools.cache
def find_peaks_smem(K: int, H: int, W: int, M: int) -> int:
    """Bytes of shared memory a block of the `find_peaks` kernel takes at
    these sizes (all K planes of a frame, csrc/find_peaks.cu PeakLayout)."""
    fn = _build.library("find_peaks").popnet_find_peaks_smem
    fn.argtypes, fn.restype = [_I] * 4, ctypes.c_longlong
    return int(fn(K, H, W, M))


@functools.cache
def find_peaks_row_smem(K: int, H: int, W: int, M: int) -> int:
    """Bytes of shared memory a CTA of the `find_peaks_row` kernel takes at
    these sizes (csrc/find_peaks.cu row_config), or -1 where that kernel
    cannot take them: a side over 255 cells (its survivor keys hold a cell
    in 16 bits), or not one plane in a CTA."""
    fn = _build.library("find_peaks").popnet_find_peaks_row_smem
    fn.argtypes, fn.restype = [_I] * 4, ctypes.c_longlong
    return int(fn(K, H, W, M))


@functools.cache
def find_peaks_plane_config(B: int, K: int, H: int, W: int, M: int) -> dict | None:
    """How the `find_peaks_plane` kernel takes B frames of K planes of H x W
    cells at M peaks (csrc/find_peaks.cu plane_config): {"cluster": CTAs a
    plane, "warps": warps a CTA, "rows": rows a band, "smem": dynamic shared
    memory a CTA in bytes}; None where it cannot take them (not three rows
    of W floats in a CTA's shared memory, or more CTAs than a grid holds)."""
    fn = _build.library("find_peaks").popnet_find_peaks_plane_config
    fn.argtypes, fn.restype = [_I] * 5 + [_P], ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(B, K, H, W, M, ctypes.addressof(out))
    if err == 1:                                      # cudaErrorInvalidValue: sizes it cannot take
        return None
    if err != 0:
        raise RuntimeError(f"popnet_find_peaks_plane_config failed: CUDA error {err}")
    return dict(zip(("cluster", "warps", "rows", "smem"), out))


def find_peaks_route(K: int, H: int, W: int, M: int) -> str:
    """The kernel `find_peaks` launches at these sizes: "find_peaks" (K1)
    where the sides are at most 255 cells and a frame's K planes fit one
    block's SMEM_PER_BLOCK; else "find_peaks_plane", which takes any size
    and spreads few planes over the card. K2 (`find_peaks_row`), which
    takes some of the same maps, was the slower at every size and batch
    measured (PERF.md section 6, chip_smoke.py phase 13 (b)) and launches
    only when called by name. A query of the sizes: no launch is tried."""
    if H <= 255 and W <= 255 and find_peaks_smem(K, H, W, M) <= SMEM_PER_BLOCK:
        return "find_peaks"
    return "find_peaks_plane"


def _find_peaks_launch(symbol: str, heat, max_peaks, thresh, factor, win_size):
    B, K, H, W = heat.shape
    _find_peaks_args(heat, max_peaks, win_size, factor)
    dev = heat.device
    U = _upsample(2 * win_size + 1, factor, dev)
    px, py, loc = (torch.empty((B, K, max_peaks), dtype=torch.int32, device=dev)
                   for _ in range(3))
    score = torch.empty((B, K, max_peaks), dtype=torch.float32, device=dev)
    valid = torch.empty((B, K, max_peaks), dtype=torch.bool, device=dev)
    # the row kernel may read whole pixel runs up to the end of the storage
    storage = heat.untyped_storage()
    readable = ([storage.data_ptr() + storage.nbytes() - heat.data_ptr()]
                if symbol == "popnet_find_peaks_row" else [])
    _launch(symbol, dev, heat.data_ptr(), *heat.stride(), *readable, B, K, H, W,
            max_peaks, thresh, win_size, factor, U.data_ptr(), px.data_ptr(),
            py.data_ptr(), loc.data_ptr(), score.data_ptr(), valid.data_ptr())
    return px, py, loc, score, valid


def find_peaks(heat: torch.Tensor, max_peaks: int = 16, thresh: float = 0.1,
               factor: int = 8, win_size: int = 2):
    """Peak NMS + top-M + windowed bicubic refine over (B, K, H, W) float32
    heat planes (any strides). Same contract as `find_peaks_plain`; on the
    card win_size=2, factor=8 and at most 32 peaks, as the decode uses; maps
    of any size.

    On the card one block per frame holds all K planes (this kernel, K1)
    where they fit a block's shared memory (`find_peaks_smem` at most
    SMEM_PER_BLOCK) and no side exceeds 255 cells. Where they do not (18
    planes from 46x47 cells on, the COCO evaluation canvas of every image
    that is not square; a side over 255 cells), the call is
    `find_peaks_plane`, which counts its launch as its own
    (`find_peaks_route`). The kernels agree bit for bit."""
    if not _on_cuda(heat):
        return find_peaks_plain(heat, max_peaks, thresh, factor, win_size)
    _find_peaks_args(heat, max_peaks, win_size, factor)
    _, K, H, W = heat.shape
    if find_peaks_route(K, H, W, max_peaks) == "find_peaks_plane":
        return find_peaks_plane(heat, max_peaks, thresh, factor, win_size)
    out = _find_peaks_launch("popnet_find_peaks", heat, max_peaks, thresh, factor, win_size)
    find_peaks.launches += 1
    return out


# ---- K2: the same function, a cluster of 2 CTAs per frame ----------------------


def find_peaks_row(heat: torch.Tensor, max_peaks: int = 16, thresh: float = 0.1,
                   factor: int = 8, win_size: int = 2):
    """`find_peaks` by its second kernel (a cluster of 2 CTAs per frame,
    each owning every other plane, loaded through distributed shared memory,
    the frame's refines shared by all 12 warps).
    Same contract and plain version as `find_peaks`, but on the card only
    maps it can hold (`find_peaks_row_smem`; else a ValueError); the
    kernels agree bit for bit."""
    if not _on_cuda(heat):
        return find_peaks_plain(heat, max_peaks, thresh, factor, win_size)
    _find_peaks_args(heat, max_peaks, win_size, factor)
    _, K, H, W = heat.shape
    if find_peaks_row_smem(K, H, W, max_peaks) < 0:
        raise ValueError(f"find_peaks_row cannot hold {K} planes of {H}x{W} cells (a side over "
                         f"255 cells, or a plane over one CTA's shared memory): find_peaks "
                         f"takes them by find_peaks_plane")
    out = _find_peaks_launch("popnet_find_peaks_row", heat, max_peaks, thresh, factor,
                             win_size)
    find_peaks_row.launches += 1
    return out


# ---- the same function at any map size, a cluster of CTAs per plane --------------


def find_peaks_plane(heat: torch.Tensor, max_peaks: int = 16, thresh: float = 0.1,
                     factor: int = 8, win_size: int = 2):
    """`find_peaks` by its third kernel: each plane's rows in bands over a
    cluster of up to 8 CTAs where the frames' planes are fewer than the SMs
    (one CTA a plane where they are not), each band copied to shared memory
    with its halo, the NMS survivors kept on chip in each warp's sorted
    top-M list, the lists merged within the CTA and then across the cluster
    through distributed shared memory, the refines dealt to all the
    cluster's warps (`find_peaks_plane_config`). Maps K1 cannot hold, of
    any size and at any batch, the COCO evaluation canvases among them.
    Same contract and plain version as `find_peaks`; the kernels agree bit
    for bit. On the card, sizes it cannot take (a row too wide for three
    rows in a CTA) raise a ValueError."""
    if not _on_cuda(heat):
        return find_peaks_plain(heat, max_peaks, thresh, factor, win_size)
    _find_peaks_args(heat, max_peaks, win_size, factor)
    B, K, H, W = heat.shape
    if find_peaks_plane_config(B, K, H, W, max_peaks) is None:
        raise ValueError(f"find_peaks_plane cannot take {B} frames of {K} planes of {H}x{W} "
                         f"cells at {max_peaks} peaks (three rows of {W} floats must fit one "
                         f"CTA's shared memory, and B * K * 8 CTAs one grid)")
    out = _find_peaks_launch("popnet_find_peaks_plane", heat, max_peaks, thresh, factor,
                             win_size)
    find_peaks_plane.launches += 1
    return out


# ---- K3: PAF line integral over every peak pair of every limb -------------


def _cubic_tap_weight(frac: torch.Tensor, j: int, a: float = -0.75) -> torch.Tensor:
    """Keys cubic weight of tap j (offset j - 1 from floor), a = -0.75."""
    tt = (frac - (j - 1.0)).abs()
    t2 = tt * tt
    t3 = tt * t2
    near = (a + 2) * t3 - (a + 3) * t2 + 1
    far = a * t3 - 5 * a * t2 + 8 * a * tt - 4 * a
    return torch.where(tt <= 1, near, torch.where(tt < 2, far, torch.zeros_like(tt)))


def paf_line_sums_plain(paf: torch.Tensor, srcx, srcy, dx, dy, ux, uy,
                        num_pts: int = 10, factor: int = 8, thresh: float = 0.05):
    """Sum of projections and count above `thresh` along each pair's line.

    paf: (B, H, W, 2L) float32; srcx..uy: (B, L, P) pair geometry.
    The planes are read as if edge-padded by 2; a tap beyond that pad
    contributes 0. Returns (proj_sum, count), each (B, L, P) float32 — the
    contract of the TPU kernel paf_sample_pallas."""
    B, H, W, C = paf.shape
    L = C // 2
    Hp, Wp = H + 4, W + 4
    planes = paf.float().permute(0, 3, 1, 2).reshape(B, L, 2, H * W)
    acc = torch.zeros_like(srcx)
    cnt = torch.zeros_like(srcx)
    for t in range(num_pts):
        ts = t / (num_pts - 1.0)
        pxi = torch.round(srcx + dx * ts)
        pyi = torch.round(srcy + dy * ts)
        lx = (pxi + 0.5) / factor - 0.5
        ly = (pyi + 0.5) / factor - 0.5
        x0 = torch.floor(lx)
        y0 = torch.floor(ly)
        fx = lx - x0
        fy = ly - y0
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        wy = [_cubic_tap_weight(fy, j) for j in range(4)]
        vx = torch.zeros_like(srcx)
        vy = torch.zeros_like(srcx)
        for jx in range(4):
            qx = x0i + 1 + jx
            colx = torch.zeros_like(srcx)
            coly = torch.zeros_like(srcx)
            for jy in range(4):
                qy = y0i + 1 + jy
                inside = (qx >= 0) & (qx < Wp) & (qy >= 0) & (qy < Hp)
                flat = (qy - 2).clamp(0, H - 1) * W + (qx - 2).clamp(0, W - 1)
                v = planes.gather(3, flat[:, :, None, :].expand(B, L, 2, -1))
                v = torch.where(inside[:, :, None, :], v, torch.zeros_like(v))
                colx = colx + wy[jy] * v[:, :, 0]
                coly = coly + wy[jy] * v[:, :, 1]
            wx = _cubic_tap_weight(fx, jx)
            vx = vx + wx * colx
            vy = vy + wx * coly
        proj = vx * ux + vy * uy
        acc = acc + proj
        cnt = cnt + (proj > thresh).float()
    return acc, cnt


def _pair_geometry(peaks: torch.Tensor, limbs: tuple):
    """Per limb and src-major pair: src coords, d = dst - src, |d| + 1e-8
    and u = d / (|d| + 1e-8), each (B, L, M, M)."""
    la = _limbs(limbs, peaks.device)
    src = peaks[:, la[:, 0]]                                     # (B, L, M, 3)
    dst = peaks[:, la[:, 1]]
    M = peaks.shape[2]
    sx = src[:, :, :, None, 0].expand(-1, -1, M, M)
    sy = src[:, :, :, None, 1].expand(-1, -1, M, M)
    dx = dst[:, :, None, :, 0] - src[:, :, :, None, 0]
    dy = dst[:, :, None, :, 1] - src[:, :, :, None, 1]
    dist = torch.sqrt(dx * dx + dy * dy) + 1e-8
    return sx, sy, dx, dy, dist, dx / dist, dy / dist


def paf_score_plain(paf: torch.Tensor, peaks: torch.Tensor, peak_valid: torch.Tensor,
                    limbs: tuple, num_pts: int = 10, factor: int = 8,
                    thresh: float = 0.05):
    """Plain version of `paf_score`.

    paf (B, H, W, 2L), peaks (B, K, M, 3) float32, peak_valid (B, K, M).
    Returns (score, ok), each (B, L, M, M): mean projection plus the length
    penalty min(0.5 * H * factor / |d| - 1, 0), and ok = more than 0.8 *
    num_pts samples above `thresh`, score > 0, both peaks valid."""
    B, H, _, _ = paf.shape
    M = peaks.shape[2]
    L = len(limbs)
    sx, sy, dx, dy, dist, ux, uy = _pair_geometry(peaks.float(), limbs)
    flat = [a.reshape(B, L, M * M) for a in (sx, sy, dx, dy, ux, uy)]
    psum, pcnt = paf_line_sums_plain(paf, *flat, num_pts=num_pts, factor=factor,
                                     thresh=thresh)
    mean = psum.reshape(B, L, M, M) / torch.full_like(dist, float(num_pts))
    penalty = (torch.full_like(dist, 0.5 * H * factor) / dist - 1.0).clamp(max=0.0)
    score = mean + penalty
    la = _limbs(limbs, peaks.device)
    ok = ((pcnt.reshape(B, L, M, M) > 0.8 * num_pts) & (score > 0)
          & peak_valid[:, la[:, 0], :, None] & peak_valid[:, la[:, 1], None, :])
    return score, ok


@functools.cache
def paf_score_groups(K: int, L: int, M: int, H: int, W: int) -> tuple[int, int]:
    """(G, bytes): the blocks a frame over which the paf_score kernel splits
    its L limbs at these sizes, the smallest G whose largest group of limbs
    fits a block's 227 KB of shared memory (1 at every depth shape, 2 at
    COCO's 46x46 with 19 limbs), and the shared memory a block takes then.
    G is 0 where even one limb a block does not fit; bytes is then what one
    limb a block would take."""
    fn = _build.library("paf_score").popnet_paf_score_groups
    fn.argtypes, fn.restype = [_I] * 5 + [_P, _P], ctypes.c_int
    g, nbytes = ctypes.c_int(0), ctypes.c_longlong(0)
    err = fn(K, L, M, H, W, ctypes.addressof(g), ctypes.addressof(nbytes))
    if err != 0:
        raise RuntimeError(f"popnet_paf_score_groups failed: CUDA error {err}")
    return g.value, nbytes.value


def paf_score(paf: torch.Tensor, peaks: torch.Tensor, peak_valid: torch.Tensor,
              limbs: tuple, num_pts: int = 10, factor: int = 8, thresh: float = 0.05):
    """PAF scores of every (src, dst) peak pair of every limb. paf may have
    any strides; peaks and peak_valid are contiguous. Maps larger than a
    block's shared memory are split over blocks by groups of limbs
    (`paf_score_groups`); a size where one limb does not fit raises. Same
    contract as `paf_score_plain`."""
    if not _on_cuda(paf, peaks, peak_valid):
        return paf_score_plain(paf, peaks, peak_valid, limbs, num_pts, factor, thresh)
    B, H, W, C = paf.shape
    L = len(limbs)
    K, M = peaks.shape[1], peaks.shape[2]
    _check(paf, "paf", torch.float32, (B, H, W, 2 * L))
    _check(peaks, "peaks", torch.float32, (B, K, M, 3), contiguous=True)
    _check(peak_valid, "peak_valid", torch.bool, (B, K, M), contiguous=True)
    if M > 32 or L > 32 or not 2 <= num_pts <= 32:
        raise ValueError(f"paf_score takes at most 32 peaks per joint, 32 limbs and 2 to 32 "
                         f"line points, got {M}, {L}, {num_pts}")
    groups, nbytes = paf_score_groups(K, L, M, H, W)
    if groups == 0:
        raise ValueError(f"paf_score cannot hold ({H}, {W}) maps: one limb a block takes "
                         f"{nbytes} bytes of shared memory with K={K}, M={M}, over the "
                         f"{227 * 1024} a block may have")
    dev = paf.device
    lt = _limbs_i32(limbs, dev)
    score = torch.empty((B, L, M, M), dtype=torch.float32, device=dev)
    ok = torch.empty((B, L, M, M), dtype=torch.bool, device=dev)
    sb, sy, sx, sc = paf.stride()
    _launch("popnet_paf_score", dev, paf.data_ptr(), sb, sy, sx, sc, peaks.data_ptr(),
            peak_valid.data_ptr(), lt.data_ptr(), B, K, L, M, H, W, num_pts,
            float(factor), thresh, 0.5 * H * factor, score.data_ptr(), ok.data_ptr())
    paf_score.launches += 1
    return score, ok


# ---- K4: heat-weighted window readout ---------------------------------------


def window_readout_plain(z: torch.Tensor, heat: torch.Tensor, cx: torch.Tensor,
                         cy: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Plain version of `window_readout`. z, heat: (B, H, W, K) float32;
    cx, cy: (B, P, K) int32 window centres. Returns (B, P, K) float32."""
    B, H, W, K = z.shape
    x0 = (cx.long() - radius).clamp(0, W - 1)
    x1 = (cx.long() + radius).clamp(0, W - 1)
    y0 = (cy.long() - radius).clamp(0, H - 1)
    y1 = (cy.long() + radius).clamp(0, H - 1)
    bi = torch.arange(B, device=z.device)[:, None, None]
    ki = torch.arange(K, device=z.device)[None, None, :]
    zf = z.float()
    hr = heat.float().clamp(min=0.0)
    s_zh = s_h = s_z = torch.zeros(cx.shape, dtype=torch.float32, device=z.device)
    for dx in range(2 * radius + 1):
        xs = x0 + dx
        c_zh = c_h = c_z = torch.zeros_like(s_z)
        for dy in range(2 * radius + 1):
            ys = y0 + dy
            inside = (xs <= x1) & (ys <= y1)
            yc, xc = ys.clamp(max=H - 1), xs.clamp(max=W - 1)
            zv = torch.where(inside, zf[bi, yc, xc, ki], 0.0)
            hv = torch.where(inside, hr[bi, yc, xc, ki], 0.0)
            c_zh = c_zh + zv * hv
            c_h = c_h + hv
            c_z = c_z + zv
        s_zh, s_h, s_z = s_zh + c_zh, s_h + c_h, s_z + c_z
    cnt = ((y1 - y0 + 1) * (x1 - x0 + 1)).float()
    return (s_zh + 1e-9 * s_z) / (s_h + 1e-9 * cnt)


def window_readout(z: torch.Tensor, heat: torch.Tensor, cx: torch.Tensor,
                   cy: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(sum z*relu(h) + 1e-9 sum z) / (sum relu(h) + 1e-9 n) over the window
    clip(c - r)..clip(c + r). z and heat may have any strides."""
    if not _on_cuda(z, heat, cx, cy):
        return window_readout_plain(z, heat, cx, cy, radius)
    B, H, W, K = z.shape
    P = cx.shape[1]
    _check(z, "z", torch.float32)
    _check(heat, "heat", torch.float32, (B, H, W, K))
    _check(cx, "cx", torch.int32, (B, P, K), contiguous=True)
    _check(cy, "cy", torch.int32, (B, P, K), contiguous=True)
    out = torch.empty((B, P, K), dtype=torch.float32, device=z.device)
    _launch("popnet_window_readout", z.device, z.data_ptr(), *z.stride(), heat.data_ptr(),
            *heat.stride(), cx.data_ptr(), cy.data_ptr(), B, P, K, H, W, radius,
            out.data_ptr())
    window_readout.launches += 1
    return out


# ---- K5: point readout --------------------------------------------------------


def point_readout_plain(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Plain version of `point_readout`: img (B, H, W), cx, cy (B, P) int32 ->
    img[b, cy, cx] (B, P) float32; a point off the image reads 0."""
    B, H, W = img.shape
    inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    bi = torch.arange(B, device=img.device)[:, None]
    v = img.float()[bi, cy.long().clamp(0, H - 1), cx.long().clamp(0, W - 1)]
    return torch.where(inside, v, 0.0)


def point_readout(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """img[b, cy, cx] for int32 points (B, P); img may have any strides."""
    if not _on_cuda(img, cx, cy):
        return point_readout_plain(img, cx, cy)
    B, H, W = img.shape
    P = cx.shape[1]
    _check(img, "img", torch.float32)
    _check(cx, "cx", torch.int32, (B, P), contiguous=True)
    _check(cy, "cy", torch.int32, (B, P), contiguous=True)
    out = torch.empty((B, P), dtype=torch.float32, device=img.device)
    _launch("popnet_point_readout", img.device, img.data_ptr(), *img.stride(),
            cx.data_ptr(), cy.data_ptr(), B, P, H, W, out.data_ptr())
    point_readout.launches += 1
    return out


# ---- K4 + K5: both readouts of the decode in one launch ------------------------


def readout_points(joints: torch.Tensor, Hi: int, Wi: int, downsample: int = 8):
    """Where the readouts look for joints (B, P, K, >=2) in input-image
    coordinates: the window centres trunc(x / downsample), trunc(y /
    downsample) on the maps and the points trunc(clip(x, 0, Wi - 1)),
    trunc(clip(y, 0, Hi - 1)) on the (Hi, Wi) image, each (B, P, K) int32.
    The division is by a tensor, so it is a true division on every device
    (the card multiplies by the reciprocal of a Python number)."""
    x, y = joints[..., 0].float(), joints[..., 1].float()
    ds = _const(("downsample", float(downsample)), lambda: torch.tensor(float(downsample)),
                joints.device)
    gx, gy = (x / ds).to(torch.int32), (y / ds).to(torch.int32)
    rx = x.clamp(0, Wi - 1).to(torch.int32)
    ry = y.clamp(0, Hi - 1).to(torch.int32)
    return gx, gy, rx, ry


def readouts_plain(z: torch.Tensor, heat: torch.Tensor, joints: torch.Tensor,
                   img: torch.Tensor, std: float, mean: float, downsample: int = 8,
                   radius: int = 1):
    """Plain version of `readouts`: the points of `readout_points`, the
    affines z * std + mean and img * std + mean over the whole maps, then
    `window_readout_plain` and `point_readout_plain`. Returns (z_pose,
    z_raw), each (B, P, K) float32."""
    B, P, K = joints.shape[:3]
    gx, gy, rx, ry = readout_points(joints, img.shape[1], img.shape[2], downsample)
    z_pose = window_readout_plain(z.float() * std + mean, heat, gx, gy, radius)
    z_raw = point_readout_plain(img.float() * std + mean, rx.reshape(B, P * K),
                                ry.reshape(B, P * K))
    return z_pose, z_raw.reshape(B, P, K)


_MAP_TYPES = (torch.float32, torch.bfloat16)


def readouts(z: torch.Tensor, heat: torch.Tensor, joints: torch.Tensor, img: torch.Tensor,
             std: float, mean: float, downsample: int = 8, radius: int = 1):
    """The heat-weighted window readout of the z map (K4) and the point
    readout of the image (K5) at joints (B, P, K, >=2) float32, in one
    launch. z (B, H, W, K) and img (B, Hi, Wi) are the normalized maps,
    float32 or bfloat16, any strides; each value read is denormalized as v *
    std + mean. heat (B, H, W, K) float32, any strides. Same contract as
    `readouts_plain`; counts one launch of `window_readout` and of
    `point_readout` besides its own."""
    if not _on_cuda(z, heat, joints, img):
        return readouts_plain(z, heat, joints, img, std, mean, downsample, radius)
    B, H, W, K = z.shape
    P = joints.shape[1]
    Hi, Wi = img.shape[1], img.shape[2]
    for t, name in ((z, "z"), (img, "img")):
        if t.dtype not in _MAP_TYPES:
            raise ValueError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    _check(heat, "heat", torch.float32, (B, H, W, K))
    _check(joints, "joints", torch.float32)
    if img.dim() != 3 or img.shape[0] != B or joints.dim() != 4 \
            or tuple(joints.shape[:3]) != (B, P, K) or joints.shape[3] < 2:
        raise ValueError(f"readouts: img (B, Hi, Wi) and joints (B, P, K, >=2) for z "
                         f"{tuple(z.shape)}, got {tuple(img.shape)} and {tuple(joints.shape)}")
    dev = z.device
    z_pose = torch.empty((B, P, K), dtype=torch.float32, device=dev)
    z_raw = torch.empty((B, P, K), dtype=torch.float32, device=dev)
    _launch("popnet_readouts", dev, z.data_ptr(), *z.stride(), int(z.dtype == torch.bfloat16),
            heat.data_ptr(), *heat.stride(), joints.data_ptr(), *joints.stride(),
            img.data_ptr(), *img.stride(), int(img.dtype == torch.bfloat16), B, P, K, H, W,
            Hi, Wi, radius, float(downsample), float(std), float(mean), z_pose.data_ptr(),
            z_raw.data_ptr())
    readouts.launches += 1
    window_readout.launches += 1
    point_readout.launches += 1
    return z_pose, z_raw


# ---- K6: greedy person assembly to packed peak-id tables ----------------------


def assemble_ids_plain(peak_score: torch.Tensor, s_masked: torch.Tensor, limbs: tuple,
                       max_people: int = 16, min_parts: int = 3, min_score: float = 0.2):
    """Plain version of `assemble_ids`: Python loops over batch-vectorized
    tensor ops.

    peak_score (B, K, M) float32; s_masked (B, L, M, M) float32 pair scores
    with -inf at non-candidates. Returns (ids (B, max_people, K) int32 peak
    indices with -1 holes, counts (B,) int32).

    1. per limb, M rounds of masked argmax over the (M, M) scores, each
       killing the picked row and column: a stable sort by descending score
       with the first-flat-index tie rule;
    2. a sequential union-merge over the L*M connections (limb-major) into a
       (L*M, K) slot table, in creation order;
    3. keep slots that are alive with count >= min_parts and a float32 mean
       score >= min_score, packed in creation order."""
    B, K, M = peak_score.shape
    L = len(limbs)
    P = L * M
    dev = peak_score.device
    peak_score = peak_score.float()
    ninf = torch.full((), float("-inf"), device=dev)

    # ---- stage 1: per-limb greedy 1-1 matching, descending score ----------
    s = s_masked.float().reshape(B, L, M * M)
    ar = torch.arange(M, device=dev)
    ci, cj, cv = [], [], []
    for _ in range(M):
        idx = s.argmax(dim=-1)                                   # (B, L), first max
        val = s.gather(-1, idx[..., None])[..., 0]
        i, j = idx // M, idx % M
        kill = (i[..., None, None] == ar[:, None]) | (j[..., None, None] == ar[None, :])
        s = torch.where(kill.reshape(B, L, M * M), ninf, s)
        ci.append(i)
        cj.append(j)
        cv.append(val)
    ci = torch.stack(ci, -1).reshape(B, P)          # limb-major, pick order within
    cj = torch.stack(cj, -1).reshape(B, P)
    cv = torch.stack(cv, -1).reshape(B, P)
    cgood = torch.isfinite(cv)
    cv = torch.where(cgood, cv, 0.0)

    # ---- stage 2: sequential union-merge over connections -----------------
    bar = torch.arange(B, device=dev)
    slot = torch.arange(P, device=dev)
    ids = torch.full((B, P, K), -1, dtype=torch.int32, device=dev)
    score = torch.zeros((B, P), dtype=torch.float32, device=dev)
    count = torch.zeros((B, P), dtype=torch.int32, device=dev)
    alive = torch.zeros((B, P), dtype=torch.bool, device=dev)
    ncre = torch.zeros((B,), dtype=torch.int64, device=dev)
    for n in range(P):
        src_t, dst_t = limbs[n // M]
        i = ci[:, n].to(torch.int32)
        j = cj[:, n].to(torch.int32)
        cs, good = cv[:, n], cgood[:, n]

        match = alive & ((ids[:, :, src_t] == i[:, None]) | (ids[:, :, dst_t] == j[:, None]))
        a0 = match.to(torch.int8).argmax(dim=1)                  # first match, or 0
        oh0 = slot == a0[:, None]
        has0 = match.any(dim=1)
        m2 = match & ~oh0
        a1 = m2.to(torch.int8).argmax(dim=1)
        oh1 = slot == a1[:, None]
        has1 = m2.any(dim=1)

        src_sc = peak_score[bar, src_t, i.long()]
        dst_sc = peak_score[bar, dst_t, j.long()]
        row0 = ids[bar, a0]                                      # (B, K)
        row1 = ids[bar, a1]
        sc0, sc1 = score[bar, a0], score[bar, a1]
        ct0, ct1 = count[bar, a0], count[bar, a1]

        already = row0[:, dst_t] == j
        overlap = ((row0 >= 0) & (row1 >= 0)).any(dim=1)
        case_new = good & ~has0
        case_two = good & has1
        case_setdst = (good & has0 & ~has1 & ~already) | (case_two & overlap)
        case_merge = case_two & ~overlap
        do_write = case_new | case_setdst | case_merge

        row_setdst = row0.clone()
        row_setdst[:, dst_t] = j
        row_new = torch.full_like(row0, -1)
        row_new[:, src_t] = i
        row_new[:, dst_t] = j
        new_row = torch.where(case_new[:, None], row_new,
                              torch.where(case_merge[:, None], row0 + row1 + 1, row_setdst))
        new_sc = torch.where(case_new, src_sc + dst_sc + cs,
                             torch.where(case_merge, sc0 + sc1 + cs, sc0 + dst_sc + cs))
        new_ct = torch.where(case_new, 2, torch.where(case_merge, ct0 + ct1, ct0 + 1))

        p_tgt = torch.where(case_new, ncre, a0)
        wmask = (slot == p_tgt[:, None]) & do_write[:, None]     # (B, P)
        ids = torch.where(wmask[:, :, None], new_row[:, None, :], ids)
        score = torch.where(wmask, new_sc[:, None], score)
        count = torch.where(wmask, new_ct.to(torch.int32)[:, None], count)
        alive = (alive | wmask) & ~(oh1 & case_merge[:, None])
        ncre = ncre + case_new.long()

    # ---- stage 3: filter + pack in creation order ---------------------------
    # f32 division, as the native assembler's `score / count < min_score`
    mean_sc = score / count.clamp(min=1).float()
    survive = alive & (count >= min_parts) & (mean_sc >= min_score)
    rank = survive.long().cumsum(dim=1) - 1
    keep = survive & (rank < max_people)
    counts = survive.sum(dim=1).clamp(max=max_people).to(torch.int32)
    out_slot = torch.where(keep, rank, max_people)               # dump slot
    out_ids = torch.full((B, max_people + 1, K), -1, dtype=torch.int32, device=dev)
    out_ids.scatter_(1, out_slot[:, :, None].expand(B, P, K),
                     torch.where(keep[:, :, None], ids, -1))
    return out_ids[:, :max_people], counts


def assemble_ids(peak_score: torch.Tensor, s_masked: torch.Tensor, limbs: tuple,
                 max_people: int = 16, min_parts: int = 3, min_score: float = 0.2):
    """Greedy assembly of one batch in one launch, one block per frame.
    peak_score (B, K, M) and s_masked (B, L, M, M) are contiguous float32,
    K and M at most 32 (M = 16, the decode's, has its own build of the
    kernel; any other M takes the one for 32). Same contract as
    `assemble_ids_plain`."""
    if not _on_cuda(peak_score, s_masked):
        return assemble_ids_plain(peak_score, s_masked, limbs, max_people, min_parts,
                                  min_score)
    B, K, M = peak_score.shape
    L = len(limbs)
    _check(peak_score, "peak_score", torch.float32, contiguous=True)
    _check(s_masked, "s_masked", torch.float32, (B, L, M, M), contiguous=True)
    if K > 32 or M > 32:
        raise ValueError(f"assemble_ids takes at most 32 joints and 32 peaks, got {K}, {M}")
    dev = peak_score.device
    ids = torch.empty((B, max_people, K), dtype=torch.int32, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch("popnet_assemble", dev, peak_score.data_ptr(), s_masked.data_ptr(),
            _limbs_i32(limbs, dev).data_ptr(), B, K, L, M, max_people, min_parts,
            min_score, ids.data_ptr(), counts.data_ptr())
    assemble_ids.launches += 1
    return ids, counts


# ---- K7: cross-footprint local-maximum mask -------------------------------------


def peak_local_max_plain(heat: torch.Tensor, thresh: float = float("-inf")) -> torch.Tensor:
    """Plain version of `peak_local_max`. heat (B, K, H, W) float32 -> bool
    (B, K, H, W): h >= each of its four cross neighbours (-inf off the
    plane), and h > thresh unless thresh is -inf. A plateau marks every
    cell of it."""
    h = heat.float()
    pad = F.pad(h, (1, 1, 1, 1), value=float("-inf"))
    mx = torch.maximum(torch.maximum(pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]),
                       torch.maximum(pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]))
    mask = h >= mx
    return mask & (h > thresh) if thresh > float("-inf") else mask


def peak_local_max(heat: torch.Tensor, thresh: float = float("-inf")) -> torch.Tensor:
    """Local-maximum mask of (B, K, H, W) float32 planes (any strides), one
    thread per column; the mask comes back in the memory order of the planes.
    Same contract as `peak_local_max_plain`."""
    if not _on_cuda(heat):
        return peak_local_max_plain(heat, thresh)
    B, K, H, W = heat.shape
    _check(heat, "heat", torch.float32)
    out = torch.empty_like(heat, dtype=torch.bool)
    _launch("popnet_peak_mask", heat.device, heat.data_ptr(), *heat.stride(), B, K, H, W,
            thresh, out.data_ptr(), *out.stride())
    peak_local_max.launches += 1
    return out


def peak_mask(heat: torch.Tensor, thresh: float) -> torch.Tensor:
    """(B, H, W, C) heat -> bool (B, H, W, C) peak mask: local maximum of
    the cross footprint and above `thresh`."""
    return peak_local_max(heat.float().permute(0, 3, 1, 2), thresh).permute(0, 2, 3, 1)


KERNELS = (find_peaks, find_peaks_row, find_peaks_plane, paf_score, window_readout,
           point_readout, assemble_ids, peak_local_max)      # one wrapper per CUDA kernel
for _k in KERNELS + (readouts,):
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS + (readouts,):
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel (a `readouts` launch counts
    for `window_readout` and `point_readout`; its own count is
    `readouts.launches`)."""
    return {k.__name__: k.launches for k in KERNELS}
