"""Integer-weight matrix product (the OPSC front segment's projections):
the CUDA kernels' wrapper, its route choice and launch counts, and its
plain PyTorch version.

The kernels (``csrc/dequant_matmul.cu``) replace the Pallas TPU kernel
``repro/kernels/dequant_matmul.py::dequant_matmul``, which widens any
integer tile to f32:

  x      (M, K)  f32 or bf16
  codes  (K, N)  int8 symmetric weight codes, or int16 (9 to 15 bits)
  scale  (N,)    f32    one scale per output channel
  out    (M, N)  f32    (x @ codes) * scale, summed in f32

The dequantized weights never exist in device memory. Unlike the TPU
kernel it takes any M, N, K. ``models.layers.matmul`` routes every
projection whose weight is a ``core.quant.QuantizedTensor`` here: the
edge segment of ``serving.split_engine.SplitEngine``.

What bounds it on an H100: at M = 1 (a decode step) reading the K·N code
bytes; at a prefill's M of a hundred the code bytes still (2·M flops a
byte, under the bf16 tensor cores' ridge of about 295), the operations
above. :func:`route` picks one of three kernels from shapes, dtypes and
alignment before the launch:

  * ``"gemv"`` (M ≤ 4): a split-K GEMV (``gemv16_kernel`` where N % 16
    == 0 and the codes and scale are 16-byte aligned, which keeps the code
    bytes in flight with 16-byte loads, x staged in shared memory and the
    K ranges added by the last block of each column tile; else the older
    ``gemv_kernel`` with its reduction launch); :func:`gemv_plan` picks
    the K split so that the blocks fill the SMs (two an SM at one row of
    x, one at four);
  * ``"tensor_cores_large_m"`` (bf16 x with M ≥ ``LARGE_M_MIN``, the same
    alignment as the next): a persistent, warp-specialised product on the
    bf16 tensor cores (``wgmma``; a producer warp feeds the shared-memory
    ring by TMA, two consumer warpgroups widen codes and multiply);
    :func:`large_plan` sizes the tiles to M and picks the K split, so
    that the units of work fill the SMs evenly;
  * ``"tensor_cores"`` (4 < M < ``LARGE_M_MIN``, bf16 x, N % 16 == 0,
    K % 8 == 0, 16-byte aligned bases, as TMA's copies need): a split-K
    product on the bf16 tensor cores (``wgmma``); :func:`tc_plan` picks
    the K split;
  * ``"cuda_cores"`` (any other M > 4: f32 x, a ragged N or K): the tiled
    product on the CUDA cores.

int16 codes take the GEMV (M ≤ 4, ``gemv16_kernel`` at 8 codes a 16-byte
load where N % 8 == 0 and the bases are aligned) and the CUDA cores
(M > 4): a code above 256 in magnitude does not widen to bf16 exactly, so
the tensor-core kernels take int8 codes only. ``code_launches`` counts
launches by the codes' dtype.

A split product writes its K ranges' partial sums to a (splits, M, N) f32
workspace the wrapper allocates, and they are added in a fixed order (by a
second kernel, or in ``gemv16_kernel`` by the block that takes a column
tile's last ticket), so a run repeats its bits. The tickets are one int32
a tile, zeroed once per (device, stream) and reset by the kernel itself,
so a call captured in a CUDA graph replays as it ran.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tickets import tickets as _tickets

GEMV_MAX_M = 4  # at most this many rows of x take the split-K GEMV
MIN_SPLIT_ROWS = 128  # rows of codes a GEMV K range holds at least
# GEMV blocks the K split aims for on each SM, by rows of x a block: 2
# resident blocks at one row, one at four (``gemv16_kernel`` holds 64
# accumulators a lane there); from ``python -m
# repro_torch.kernels.decode_probe`` on an H100 SXM
GEMV_BLOCKS_PER_SM = {1: 2, GEMV_MAX_M: 1}
# bytes of x (f32) a GEMV block stages in shared memory at most; its K
# range is cut to fit (``gemv16_kernel``: with the warps' sums, under the
# 48 KB a block has without an opt-in)
GEMV_STAGED_X = 32 * 1024
# the tensor-core kernel's rows of x and columns of out a block, its K
# step, and the blocks that fit on an SM (``tc_gemm_kernel``: 97 KB of
# shared memory, at most 128 registers a thread)
TC_TILE_M, TC_TILE_N, TC_STEP_K, TC_BLOCKS_PER_SM = 128, 128, 64, 2
TC_MIN_SPLIT_STEPS = 4  # K steps a tensor-core K range holds at least
# bf16 x with at least this many rows takes the large-M kernel
# (``tc_large_kernel``), whose tiles are 128·jn columns of out by one of
# its compiled row counts for that jn; one CTA an SM. From the sweep
# (``python -m repro_torch.kernels.sweep``, H100 SXM): at 192 rows it is
# as fast as ``tc_gemm_kernel`` or faster on each of llama2-7b's three
# product shapes; at 128 the two tie
LARGE_M_MIN = 192
LARGE_TILE_ROWS = {2: (96, 104, 128), 1: (96, 104, 128, 200, 256)}
# large_plan's cost model, fitted to ``python -m repro_torch.kernels.sweep``
# on an H100 SXM (700 W): a K step of a unit takes a + b·(rows of x) µs for
# its tile's 128-column boxes jn (the fixed part is mostly the widening of
# the codes); a split product adds its partial sums' write and read at
# about 2.5 bytes a ps and one more launch
LARGE_STEP_US = {1: (0.314, 0.00209), 2: (0.674, 0.00253)}
REDUCE_BYTES_PER_US, REDUCE_LAUNCH_US = 2.5e6, 3.0
ROUTES = ("gemv", "tensor_cores_large_m", "tensor_cores", "cuda_cores")
# the codes' dtypes the kernels take, by the name ``code_launches`` counts
CODE_DTYPES = {torch.int8: "int8", torch.int16: "int16"}


def dequant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro/kernels/ref.py::dequant_matmul_ref``):
    (x @ codes) * scale in f32 (exact widening of int8 and int16 codes)."""
    return (x.float() @ codes.float()) * scale


@functools.cache
def _launcher(code_bytes: int):
    lib = build.load("dequant_matmul")
    fn = lib.dequant_matmul_launch if code_bytes == 1 \
        else lib.dequant_matmul16_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tc_launcher():
    fn = build.load("dequant_matmul").dequant_matmul_tc_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _large_launcher():
    fn = build.load("dequant_matmul").dequant_matmul_large_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_vec(n: int, codes_address: int, scale_address: int,
             code_bytes: int = 1) -> int:
    """Codes a GEMV lane loads at once, for codes of ``code_bytes`` bytes:
    16 bytes of them (16 int8 or 8 int16 codes) where N and the bases of
    the codes and the scale allow 16-byte loads (``gemv16_kernel``), else
    8 bytes where N and the codes allow 8-byte loads, else 1
    (``gemv_kernel``)."""
    wide = 16 // code_bytes
    if n % wide == 0 and codes_address % 16 == 0 and scale_address % 16 == 0:
        return wide
    half = 8 // code_bytes
    return half if n % half == 0 and codes_address % 8 == 0 else 1


def gemv_plan(m: int, n: int, k: int, vec: int, sms: int,
              code_bytes: int = 1) -> tuple:
    """(rows of x a block, K ranges) of the GEMV for an (m, k) x (k, n)
    product with ``vec`` codes of ``code_bytes`` bytes a lane load: enough
    K ranges for about ``GEMV_BLOCKS_PER_SM`` blocks an SM (two for the
    older 8-byte and 1-byte kernel), each at least ``MIN_SPLIT_ROWS`` rows
    of codes, and each short enough that its rows of x fit in
    ``GEMV_STAGED_X`` bytes."""
    mt = 1 if m == 1 else GEMV_MAX_M
    cols = 32 * vec  # a block's columns: 32 lanes of vec codes
    per_sm = GEMV_BLOCKS_PER_SM[mt] if vec * code_bytes == 16 else 2
    blocks = -(-n // cols) * -(-m // mt)
    splits = max(1, min(-(-per_sm * sms // blocks), k // MIN_SPLIT_ROWS),
                 -(-k // (GEMV_STAGED_X // (4 * mt))))
    chunk = -(-k // splits)
    return mt, -(-k // chunk)


def tc_plan(m: int, n: int, k: int, sms: int) -> tuple:
    """(row tiles, column tiles, K ranges, rows of codes a range) of the
    tensor-core product: as many K ranges as keep every block of the
    product resident at once (``TC_BLOCKS_PER_SM`` on each of ``sms``
    SMs), each at least ``TC_MIN_SPLIT_STEPS`` steps of ``TC_STEP_K``; one
    range when the tiles alone fill the card."""
    tiles_m, tiles_n = -(-m // TC_TILE_M), -(-n // TC_TILE_N)
    steps = -(-k // TC_STEP_K)
    want = max(1, min(TC_BLOCKS_PER_SM * sms // (tiles_m * tiles_n),
                      steps // TC_MIN_SPLIT_STEPS))
    chunk = -(-steps // want)
    return tiles_m, tiles_n, -(-steps // chunk), chunk * TC_STEP_K


def large_plan(m: int, n: int, k: int, sms: int) -> tuple:
    """(rows of x a tile, 128-column boxes a tile, row tiles, column
    tiles, K ranges, rows of codes a range, CTAs) of the large-M product.
    A unit of work is a tile and a K range; ``sms`` CTAs (fewer if there
    are fewer units) walk the units in turn, so a product takes
    ``ceil(units / sms)`` rounds of a unit's K steps. The plan minimises
    the rounds times a unit's steps times the step's time
    (``LARGE_STEP_US``), plus a split product's partial sums; ties go to
    the wider tile, which reads x from L2 fewer times."""
    steps = -(-k // TC_STEP_K)
    best = None
    for jn in (2, 1):
        tiles_n = -(-n // (128 * jn))
        a, b = LARGE_STEP_US[jn]
        for bm in LARGE_TILE_ROWS[jn]:
            tiles_m = -(-m // bm)
            for want in range(1, max(1, steps // TC_MIN_SPLIT_STEPS) + 1):
                chunk = -(-steps // want)
                splits = -(-steps // chunk)
                units = tiles_m * tiles_n * splits
                cost = -(-units // sms) * chunk * (a + b * bm)
                if splits > 1:
                    cost += (2 * splits + 1) * m * n * 4 \
                        / REDUCE_BYTES_PER_US + REDUCE_LAUNCH_US
                if best is None or cost < best[0]:
                    best = (cost, (bm, jn, tiles_m, tiles_n, splits,
                                   chunk * TC_STEP_K, min(units, sms)))
    return best[1]


def route(m: int, n: int, k: int, x_dtype: torch.dtype, *addresses: int,
          code_dtype: torch.dtype = torch.int8) -> str:
    """The kernel an (m, k) x (k, n) product takes (one of ``ROUTES``),
    from its shape, x's and the codes' dtypes and the base addresses of x,
    codes and scale: by shape, not a fallback (a launch that fails
    raises). int16 codes never take the tensor cores."""
    if m <= GEMV_MAX_M:
        return "gemv"
    if code_dtype == torch.int8 and x_dtype == torch.bfloat16 \
            and n % 16 == 0 and k % 8 == 0 \
            and all(a % 16 == 0 for a in addresses):
        return "tensor_cores_large_m" if m >= LARGE_M_MIN else "tensor_cores"
    return "cuda_cores"


def dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (shapes in the module
    docstring). Raises on any input the kernel does not take; there is no
    fallback. Adds one to ``dequant_matmul.launches`` per call, to the
    route's count in ``dequant_matmul.route_launches`` and to the codes'
    dtype's in ``dequant_matmul.code_launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul launches a CUDA kernel; x is on "
                         f"{x.device} (use kernels.ops for CPU tensors)")
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[0] \
            or min(x.shape) < 1 or codes.shape[1] < 1:
        raise ValueError(f"need x (M, K) and codes (K, N), got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    m, k = x.shape
    n = codes.shape[1]
    want = {"x": (x, (torch.float32, torch.bfloat16), (m, k)),
            "codes": (codes, tuple(CODE_DTYPES), (k, n)),
            "scale": (scale, (torch.float32,), (n,))}
    for name, (t, dtypes, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    way = route(m, n, k, x.dtype, x.data_ptr(), codes.data_ptr(),
                scale.data_ptr(), code_dtype=codes.dtype)
    code_bytes = codes.element_size()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = _sm_count(x.device.index or 0)
    splits, partial = 1, None
    with torch.cuda.device(x.device):
        if way == "tensor_cores_large_m":
            bm, jn, _, _, splits, chunk, ctas = large_plan(m, n, k, sms)
            if splits > 1:
                partial = torch.empty((splits, m, n), dtype=torch.float32,
                                      device=x.device)
            err = _large_launcher()(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                out.data_ptr(),
                None if partial is None else partial.data_ptr(), m, n, k,
                bm, jn, splits, chunk, ctas, stream)
        elif way == "tensor_cores":
            _, _, splits, chunk = tc_plan(m, n, k, sms)
            if splits > 1:
                partial = torch.empty((splits, m, n), dtype=torch.float32,
                                      device=x.device)
            err = _tc_launcher()(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                out.data_ptr(),
                None if partial is None else partial.data_ptr(), m, n, k,
                splits, chunk, stream)
        else:
            vec = gemv_vec(n, codes.data_ptr(), scale.data_ptr(), code_bytes)
            mt, tickets = 0, None
            if way == "gemv":
                mt, splits = gemv_plan(m, n, k, vec, sms, code_bytes)
                if splits > 1:
                    partial = torch.empty((splits, m, n),
                                          dtype=torch.float32,
                                          device=x.device)
                    if vec * code_bytes == 16:
                        tiles = -(-n // (32 * vec)) * -(-m // mt)
                        tickets = _tickets(x.device, stream, tiles)
            err = _launcher(code_bytes)(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                None if tickets is None else tickets.data_ptr(), m, n, k,
                vec, mt, splits, stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul kernel launch failed ({way}): "
                           f"CUDA error {err}")
    dequant_matmul.launches += 1
    dequant_matmul.route_launches[way] += 1
    dequant_matmul.code_launches[CODE_DTYPES[codes.dtype]] += 1
    return out


dequant_matmul.launches = 0
dequant_matmul.route_launches = dict.fromkeys(ROUTES, 0)
dequant_matmul.code_launches = dict.fromkeys(CODE_DTYPES.values(), 0)
