"""E8 lattice codebook quantization (QuIP#-style ``e8p``, 2 bits/weight),
in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.lattice``:

- **Codebook**: the 2^16 smallest-norm points of ``E8 + 1/4`` (a 16-bit
  index per 8 weights), built once on the host in numpy (a copy of the
  reference's construction, so the tables are equal as arrays), and its
  collision-free 32-bit hash table for point -> index lookups.
- **Encode** (:func:`e8p_encode`): the Conway-Sloane nearest point in E8
  (round to D8 with a parity fix, both cosets), accepted when it is a
  codebook entry; otherwise a greedy descent over the lattice's 240 root
  neighbours from a guaranteed member, or with ``exact=True`` a brute-force
  argmin over the whole codebook. Everything runs on the device of the
  input; the shrink loop and the descent are plain Python loops.
- **Blocks**: per-block scale search over an RMS-relative grid
  (:func:`e8p_quantize_blocks`), exact code recovery from blocks already on
  the grid (:func:`e8p_recover_codes`), and the lossless repack of per-row
  blocks into the int4 W4A8 serving layout plus a rank-1 offset
  (:func:`e8p_pack_rowscale`, :func:`codes_to_int4_planes`,
  :func:`int4_planes_to_codes`).

Codes are int32 tensors (the reference's are uint16; the values are equal).
The hash is computed in int64 with the 32-bit wraparound written out, as
torch has no uint32 multiply.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

CODEBOOK_BITS = 16
DIM = 8

# Per-block scale candidates, relative to the block RMS (the reference's).
DEFAULT_SCALE_GRID = (0.7, 0.8, 0.9, 1.0, 1.1, 1.3)

_MASK32 = 0xFFFFFFFF


def _enumerate_shifted_coset(delta: float, r2: float) -> np.ndarray:
    """All vectors ``k + delta`` (k in Z^8, sum k even) with squared norm
    <= r2, by prefix extension with norm pruning."""
    kmax = int(np.floor(np.sqrt(r2) - delta)) + 1
    kmin = -int(np.floor(np.sqrt(r2) + delta)) - 1
    coords = np.arange(kmin, kmax + 1, dtype=np.int32)
    vals = coords.astype(np.float64) + delta
    keep = vals * vals <= r2
    coords, vals = coords[keep], vals[keep]

    prefixes = coords[:, None]
    norms = vals * vals
    for _ in range(DIM - 1):
        norms = (norms[:, None] + (vals * vals)[None, :]).reshape(-1)
        prefixes = np.concatenate(
            [np.repeat(prefixes, len(coords), axis=0),
             np.tile(coords[:, None], (len(prefixes), 1))], axis=1)
        keep = norms <= r2
        prefixes, norms = prefixes[keep], norms[keep]
    even = prefixes.sum(axis=1) % 2 == 0
    return prefixes[even].astype(np.float64) + delta


def build_e8p_codebook(num_entries: int = 1 << CODEBOOK_BITS,
                       r2: float = 14.0) -> np.ndarray:
    """The ``num_entries`` smallest-norm points of ``E8 + 1/4``, ties at
    equal norm broken lexicographically."""
    pts = np.concatenate([_enumerate_shifted_coset(0.25, r2),
                          _enumerate_shifted_coset(0.75, r2)], axis=0)
    if len(pts) < num_entries:
        raise ValueError(
            f"ball r2={r2} holds only {len(pts)} lattice points < "
            f"{num_entries}; increase r2")
    norms = (pts * pts).sum(axis=1)
    order = np.lexsort(tuple(pts[:, d] for d in range(DIM - 1, -1, -1))
                       + (norms,))
    return np.ascontiguousarray(pts[order[:num_entries]], dtype=np.float32)


@functools.cache
def e8p_codebook() -> np.ndarray:
    """The 2^16 x 8 float32 codebook (2 MB), built once, read-only."""
    cb = build_e8p_codebook()
    cb.flags.writeable = False
    return cb


def codebook_radius2() -> float:
    cb = e8p_codebook()
    return float((cb * cb).sum(axis=1).max())


@functools.cache
def hash_table() -> Tuple[int, np.ndarray, np.ndarray]:
    """(multiplier, sorted codebook hash keys, sort order): a 32-bit
    multiplicative mix of the coordinates ``4c + 16`` that is
    collision-free on the codebook (the reference's table)."""
    q = (np.round(e8p_codebook() * 4).astype(np.int64) + 16).astype(
        np.uint32)
    for mult in (2654435761, 2246822519, 3266489917, 668265263):
        k = np.zeros(q.shape[0], np.uint32)
        for d in range(DIM):
            k = (k ^ q[:, d]) * np.uint32(mult)
        if len(np.unique(k)) == q.shape[0]:
            order = np.argsort(k).astype(np.int32)
            keys, order = k[order], order
            keys.flags.writeable = False
            order.flags.writeable = False
            return mult, keys, order
    raise RuntimeError("no collision-free codebook hash multiplier")


@functools.cache
def e8_roots() -> np.ndarray:
    """The 240 minimal vectors of E8 (norm^2 = 2): ``(+-1, +-1, 0^6)`` and
    ``(+-1/2)^8`` with an even number of minus signs."""
    roots = []
    for i in range(DIM):
        for j in range(i + 1, DIM):
            for si in (1.0, -1.0):
                for sj in (1.0, -1.0):
                    v = np.zeros(DIM, np.float32)
                    v[i], v[j] = si, sj
                    roots.append(v)
    for bits in range(256):
        if bin(bits).count("1") % 2 == 0:
            roots.append(np.asarray(
                [(0.5 if (bits >> d) & 1 == 0 else -0.5) for d in range(DIM)],
                np.float32))
    out = np.stack(roots)
    out.flags.writeable = False
    return out


@functools.cache
def _shell_radii2() -> Tuple[float, float]:
    """(safe_r2, full_r2): norm^2 of the largest complete codebook shell and
    of the (possibly partial) boundary shell."""
    norms = np.round((e8p_codebook().astype(np.float64) ** 2).sum(1) * 4)
    full = norms.max()
    safe = norms[norms < full].max()
    return float(safe) / 4.0, float(full) / 4.0


@functools.cache
def _table(device: str, name: str) -> torch.Tensor:
    """One device copy of each host table ("codebook", "keys", "order",
    "roots"), made at first use on that device."""
    _, keys, order = hash_table()
    host = {"codebook": e8p_codebook, "roots": e8_roots,
            "keys": lambda: keys.astype(np.int64),
            "order": lambda: order}[name]()
    return torch.from_numpy(np.array(host)).to(device)


def codebook_on(device) -> torch.Tensor:
    """The codebook as a float32 tensor on ``device``."""
    return _table(str(torch.device(device)), "codebook")


# ---------------------------------------------------------------------------
# Conway-Sloane nearest point in E8
# ---------------------------------------------------------------------------

def _nearest_d8(y: torch.Tensor) -> torch.Tensor:
    """Nearest point of D8 = {x in Z^8 : sum x even} to each row of y."""
    f = torch.round(y)
    err = y - f
    worst = err.abs().argmax(dim=-1)
    rows = torch.arange(y.shape[0], device=y.device)
    flip = torch.where(err[rows, worst] >= 0, 1.0, -1.0)
    odd = (f.sum(dim=-1).to(torch.int32) % 2) != 0
    fixed = f.clone()
    fixed[rows, worst] += torch.where(odd, flip, torch.zeros_like(flip))
    return fixed


def nearest_e8(y: torch.Tensor) -> torch.Tensor:
    """Nearest point of E8 to each row of ``y`` (N, 8)."""
    cand0 = _nearest_d8(y)
    cand1 = _nearest_d8(y - 0.5) + 0.5
    d0 = ((y - cand0) ** 2).sum(dim=-1)
    d1 = ((y - cand1) ** 2).sum(dim=-1)
    return torch.where((d0 <= d1)[:, None], cand0, cand1)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------

def _mul32(k: torch.Tensor, mult: int) -> torch.Tensor:
    """``(k * mult) mod 2^32`` for int64 ``k`` in [0, 2^32), without int64
    overflow (the multiplier split in 16-bit halves)."""
    lo = k * (mult & 0xFFFF)
    hi = ((k * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _codeword_index(points: torch.Tensor) -> torch.Tensor:
    """Canonical codebook indices of exact lattice points (N, 8), by the
    hash table; a point outside the codebook maps to some index, which
    callers check by equality."""
    mult = hash_table()[0]
    dev = str(points.device)
    q = (torch.round(points * 4).to(torch.int64) + 16) & _MASK32
    k = torch.zeros(points.shape[0], dtype=torch.int64, device=dev)
    for d in range(DIM):
        k = _mul32(k ^ q[:, d], mult)
    keys = _table(dev, "keys")
    pos = torch.searchsorted(keys, k).clamp(0, keys.shape[0] - 1)
    return _table(dev, "order")[pos]


def _brute_force_encode(y: torch.Tensor, codebook: torch.Tensor,
                        chunk: int = 512) -> torch.Tensor:
    """Exact ``argmin_c ||y - c||^2`` over the codebook, in row chunks
    (distance expansion ``||c||^2 - 2 y.c``)."""
    c_norm = (codebook * codebook).sum(dim=1)
    out = []
    for s in range(0, y.shape[0], chunk):
        scores = c_norm[None, :] - 2.0 * (y[s:s + chunk] @ codebook.T)
        out.append(scores.argmin(dim=1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32,
                                                  device=y.device)


def _member_ok(pts: torch.Tensor, codebook: torch.Tensor):
    """(idx, ok): indices of lattice points and whether each is a codebook
    entry (hash lookup checked by equality)."""
    idx = _codeword_index(pts)
    ok = ((codebook[idx.long()] - pts).abs() < 1e-4).all(dim=1)
    return idx, ok


def _encode_core(y: torch.Tensor, codebook: torch.Tensor,
                 n_iter: int) -> torch.Tensor:
    """Greedy-descent encode of one slab (see :func:`e8p_encode`)."""
    p0 = nearest_e8(y - 0.25) + 0.25
    idx0, ok0 = _member_ok(p0, codebook)

    safe_r2, full_r2 = _shell_radii2()
    safe_r2 += 1e-6
    full_r2 += 1e-6
    roots = _table(str(y.device), "roots")

    # Start point: the exact round where it is a member, else the round of
    # the row shrunk toward the ball until it lands on a complete shell.
    # The shrink factor t is f32, as the reference's loop carries it.
    r = float(np.sqrt(codebook_radius2()))
    norm = torch.linalg.vector_norm(y, dim=1)
    top = torch.full_like(norm, r - 1e-3)
    base = torch.clamp(top / norm.clamp_min(1e-12), max=1.0)
    # Each pass rounds only the rows still searching (rows are independent).
    b = torch.where(ok0[:, None], p0, torch.zeros_like(p0))
    todo = torch.nonzero(~ok0)[:, 0]
    t = np.float32(1.0)
    while todo.numel() and t > np.float32(0.01):
        pt = nearest_e8(y[todo] * (base[todo] * float(t))[:, None]
                        - 0.25) + 0.25
        okn = (pt * pt).sum(dim=1) <= safe_r2
        b[todo[okn]] = pt[okn]
        todo = todo[~okn]
        t = np.float32(t * np.float32(0.9))

    best = b
    best_d = ((y - best) ** 2).sum(dim=1)
    inf = torch.tensor(float("inf"), device=y.device)
    for _ in range(n_iter):
        bn = (best * best).sum(dim=1)
        cand_n = bn[:, None] + 2.0 * (best @ roots.T) + 2.0      # ||b+v||^2
        cand_d = (best_d[:, None] - 2.0 * ((y - best) @ roots.T)
                  + 2.0)                                         # ||y-b-v||^2
        # optimistic pass over the (possibly partial) boundary shell, its
        # winner checked by hash; fallback pass over complete shells only
        d_opt = torch.where(cand_n <= full_r2, cand_d, inf)
        j_opt = d_opt.argmin(dim=1)
        d_o = d_opt.gather(1, j_opt[:, None])[:, 0]
        cand_o = best + roots[j_opt]
        _, ok_o = _member_ok(cand_o, codebook)
        d_safe = torch.where(cand_n <= safe_r2, cand_d, inf)
        j_safe = d_safe.argmin(dim=1)
        d_s = d_safe.gather(1, j_safe[:, None])[:, 0]
        cand_s = best + roots[j_safe]
        use_o = ok_o & torch.isfinite(d_o)
        cand = torch.where(use_o[:, None], cand_o, cand_s)
        d_new = torch.where(use_o, d_o, d_s)
        imp = d_new < best_d
        best = torch.where(imp[:, None], cand, best)
        best_d = torch.where(imp, d_new, best_d)

    idx, okf = _member_ok(best, codebook)
    return torch.where(okf, idx, idx0)


def e8p_encode(y: torch.Tensor, codebook: torch.Tensor, chunk: int = 512,
               exact: bool = False, n_iter: int = 3,
               slab: int = 131072) -> torch.Tensor:
    """Nearest-codeword indices (int32) for vectors ``y`` (N, 8).

    The Conway-Sloane nearest point in the shifted lattice is THE nearest
    codeword whenever it is a codebook entry. For rows whose nearest
    lattice point falls outside the codebook ball: ``exact=False`` runs
    ``n_iter`` steps of greedy descent over the 240 root neighbours from a
    guaranteed member (rows in slabs of ``slab``, which bounds the (N, 240)
    temporaries; rows are independent, so slabbing changes no bit);
    ``exact=True`` takes the brute-force argmin over the codebook for
    every row whenever any row needs it.
    """
    y = y.float()
    if exact:
        p0 = nearest_e8(y - 0.25) + 0.25
        idx0, ok0 = _member_ok(p0, codebook)
        if bool(ok0.all()):
            return idx0
        return torch.where(ok0, idx0, _brute_force_encode(y, codebook, chunk))
    n = y.shape[0]
    if slab and n > slab:
        return torch.cat([_encode_core(y[s:s + slab], codebook, n_iter)
                          for s in range(0, n, slab)])
    return _encode_core(y, codebook, n_iter)


def e8p_decode(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return codebook[idx.long()]


# ---------------------------------------------------------------------------
# Blockwise quantization with per-block scale search
# ---------------------------------------------------------------------------

def _best_scale(blocks: torch.Tensor, scales, chunk: int):
    """Encode ``blocks`` at each candidate scale (each (nb, 1)); keep, per
    block, the codes and scale of the smallest squared error (the first on
    ties)."""
    nb, bs = blocks.shape
    cb = codebook_on(blocks.device)
    codes, errs = [], []
    for s in scales:
        idx = e8p_encode((blocks / s).reshape(-1, DIM), cb, chunk=chunk)
        rec = e8p_decode(idx, cb).reshape(nb, bs) * s
        codes.append(idx.reshape(nb, bs // DIM))
        errs.append(((rec - blocks) ** 2).sum(dim=1))
    best = torch.stack(errs).argmin(dim=0)
    codes = torch.stack(codes)[best, torch.arange(nb, device=blocks.device)]
    scale = torch.stack(list(scales))[best, torch.arange(
        nb, device=blocks.device)]
    return codes, scale


def _check_blocks(blocks: torch.Tensor) -> torch.Tensor:
    if blocks.shape[1] % DIM != 0:
        raise ValueError(f"block size {blocks.shape[1]} not a multiple of "
                         f"{DIM}")
    return blocks.float()


def e8p_quantize_blocks(blocks: torch.Tensor,
                        scale_grid: Tuple[float, ...] = DEFAULT_SCALE_GRID,
                        chunk: int = 512):
    """Quantize (nb, bs) blocks (bs a multiple of 8) to E8P codes with a
    per-block scale from ``scale_grid`` x the block RMS. Returns ``(codes
    (nb, bs/8) int32, scale (nb, 1) f32)``; the reconstruction is
    ``scale * codebook[codes]``."""
    blocks = _check_blocks(blocks)
    rms = torch.sqrt((blocks * blocks).mean(dim=1, keepdim=True))
    rms = rms.clamp_min(1e-8)
    return _best_scale(blocks, [rms * g for g in scale_grid], chunk)


def e8p_recover_codes(blocks: torch.Tensor, chunk: int = 512):
    """Recover ``(codes, scale)`` from blocks already on the e8p grid.

    Codeword coordinates are odd multiples of 1/4, so a block's max
    magnitude is ``s * (2M + 1) / 4`` for some M in [0, 6]: one of the seven
    candidates ``4 * max|v| / (2M + 1)`` is the block's scale exactly, and
    encoding at it reproduces the block.
    """
    blocks = _check_blocks(blocks)
    g = blocks.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    return _best_scale(blocks, [4.0 * g / (2 * M + 1) for M in range(7)],
                       chunk)


def e8p_dequantize_blocks(codes: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """(nb, bs) blocks from (nb, bs/8) codes and (nb, 1) scales."""
    nb, nv = codes.shape
    cb = codebook_on(codes.device)
    return e8p_decode(codes.reshape(-1), cb).reshape(nb, nv * DIM) * scale


# ---------------------------------------------------------------------------
# Lossless repack into the int4 W4A8 serving layout
# ---------------------------------------------------------------------------

def e8p_pack_rowscale(W: torch.Tensor):
    """Per-row e8p quantization repacked losslessly as int4 plus rank-1.

    A codeword coordinate is ``c = (2m + 1) / 4`` with m in [-7, 6], so
    ``s * c = m * (s / 2) + s / 4``: int4 codes ``m`` with per-row scale
    ``s / 2`` (the W4A8 layout) and a per-row offset ``s / 4`` that callers
    fold into the low-rank factors. Returns ``(packed (N, K/2) uint8,
    half_scales (N, 1) f32, offsets (N, 1) f32)``.
    """
    codes, s = e8p_quantize_blocks(W.float())
    return codes_to_int4_planes(codes, W.shape[1]), s / 2.0, s / 4.0


def codes_to_int4_planes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """(..., N, K/8) e8p codes -> (..., N, K/2) uint8 row-global int4
    planes (the W4A8 serving layout)."""
    lead = codes.shape[:-1]
    c = e8p_decode(codes.reshape(-1), codebook_on(codes.device)).reshape(
        *lead, K)
    m = torch.round(2.0 * c - 0.5)                  # (4c - 1) / 2
    planes = (m + 7.0).to(torch.uint8).reshape(*lead, 2, K // 2)
    return (planes[..., 0, :] << 4) | planes[..., 1, :]


def int4_planes_to_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`codes_to_int4_planes`: the (..., N, K/8) int32
    codes (the 2-bit storage form). Raises if the unpacked values are not
    unit ``E8 + 1/4`` codewords."""
    K = packed.shape[-1] * 2
    u = torch.cat([(packed >> 4) & 0xF, packed & 0xF], dim=-1)
    pts = ((2.0 * (u.float() - 7.0) + 1.0) / 4.0).reshape(-1, DIM)
    idx, ok = _member_ok(pts, codebook_on(packed.device))
    if not bool(ok.all()):
        raise ValueError("int4 pack is not a lattice-codeword stream")
    return idx.reshape(*packed.shape[:-1], K // DIM)
