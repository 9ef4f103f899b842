"""Exact packed-genotype score test: integer contraction, f64 statistics.

The counterpart of ``saigegds_tpu/ops/score_packed.py``.  Phase 1 is
reformulated algebraically so the genotype codes are the only [B, N]-sized
operand: with per-variant missing mask ``m``, zero-filled dosages ``g0``
and hom-ALT indicator ``g2``, mean imputation and allele flip are affine
maps ``g = s*(g0 + mean*m) + t`` and the covariate adjustment
``L(v) = v - XXVX_inv (XV v)`` is linear, so (reference ``single_test_bin``
src/saige_main.cpp:279-407):

    S   = r' L(g)                    -> contractions  r'g0, r'm, XV g0, XV m
    var = sum W L(g)^2               -> adds  W'g0, W'm, W'g2, (X'W) g0,
                                        (X'W) m  and the constant K x K
                                        matrix  X'WX

i.e. phase 1 for a whole block is ONE exact integer contraction
``[G0; M; G2] @ V'`` where ``V`` stacks the 2K+3 model vectors (ones, r,
W, XV rows, (W XXVX_inv) rows), decomposed into signed-7-bit slices
(``ops/packed_grm._slice_i8``).  A block arrives by one of three routes,
told apart by its type, and all three give the same exact integers:

- planar 2-bit uint8 [B, N4] -> kernel B3 (``indicator_dot_2bit``);
- int8 codes [B, N] -> kernel B4 (``indicator_dot``);
- the gap-coded sparse stream ``(entries, row_ptr)`` -> kernel B5
  (``sparse_codes.decode_codes``) to int8 codes, then B4.

The aggregate tests' burden collapse (:func:`burden_score_packed`) builds
its weighted rows on the device from the same payloads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .packed_grm import N_SLICES, _slice_i8
from .score import ScanModel, ScanParams, ScoreStats, _valid_mask, \
    binary_stats, quant_stats, score_stats_binary, score_stats_quant
from .score_kernel import indicator_dot, indicator_dot_2bit, operand, \
    operand_2bit, padded_cols
from .sparse_codes import decode_codes

_F64 = torch.float64

# burden-collapse batching target (test-vector source rows per batch), and
# the sample chunk that bounds the transient f64 indicators of the collapse
BURDEN_S_CAP = 2048
_BURDEN_N_CHUNK = 32768


class PackedScanModel(NamedTuple):
    """Precomputed model-side state for the packed score kernel."""

    trait_binary: bool
    tau: torch.Tensor      # [2]
    V: torch.Tensor        # [2K+3, N] stacked model vectors (f64)
    XWX: torch.Tensor      # [K, K] = XXVX_inv' W XXVX_inv
    wr: torch.Tensor       # [K] = XXVX_inv' r
    u3: torch.Tensor       # [K] = XV @ 1
    v3: torch.Tensor       # [K] = XXVX_inv' W 1
    sum_r: torch.Tensor    # [] r' 1
    sum_w: torch.Tensor    # [] W' 1
    var_ratio: float
    n_cov: int             # K
    vs4: torch.Tensor      # [4, N4, Cpad] int8 plane-split zero-padded slices
    #                        (plane p rows are natural samples p*N4 ..
    #                        p*N4+N4-1); the live columns hold the values
    #                        the JAX package keeps in bf16, at half the
    #                        bytes; Cpad is score_kernel.padded_cols (the
    #                        JAX package pads to a multiple of 128)
    vs4k: torch.Tensor | None   # kernel B3's K-major layout of vs4
    #                        (score_kernel.operand_2bit), made once per
    #                        model on a card; None on the CPU
    vsk: torch.Tensor | None    # kernel B4's of vs (score_kernel.operand)
    wts: torch.Tensor      # [2K+3, S] f64 slice combine weights
    # SPA phase 2 still needs the dense model
    dense: ScanModel

    @property
    def vs(self) -> torch.Tensor:
        """[N, Cpad] int8 slices in natural sample order (kernel B4's
        operand): a view of ``vs4``, whose plane p holds samples p*N4 ..
        p*N4+N4-1, so no second copy exists."""
        return self.vs4.view(-1, self.vs4.shape[2])[:self.V.shape[1]]


def pack_scan_model(model: ScanModel) -> PackedScanModel:
    """Build the packed-kernel state from a dense ScanModel (on the
    model's device)."""
    dev = model.y.device
    XV = model.XV.cpu().numpy()            # [K, N]
    X = model.XXVX_inv.cpu().numpy()       # [N, K]
    r = model.y_mu.cpu().numpy()           # [N]
    W = model.mu2.cpu().numpy() if model.trait_binary \
        else np.ones_like(model.mu.cpu().numpy())
    K, N = XV.shape
    WX = X * W[:, None]                   # [N, K]
    V = np.concatenate([
        np.ones((1, N)),                  # row 0: ones  -> ac / n_missing
        r[None, :],                       # row 1
        W[None, :],                       # row 2
        XV,                               # rows 3 .. 3+K-1
        WX.T,                             # rows 3+K .. 3+2K-1
    ], axis=0)                            # [2K+3, N]
    # V' ~ scale * sum_s d_s / (64 * 128^s)   (ops/packed_grm._slice_i8)
    d, scale = _slice_i8(torch.from_numpy(np.ascontiguousarray(V.T))
                         .to(dev), N_SLICES)              # [N, R, S], [R]
    R = V.shape[0]
    C = R * N_SLICES
    Cpad = padded_cols(C)
    # zero rows at padded samples kill every contraction term there (the
    # pad code is irrelevant); zero columns pad C to the kernels' tiles
    N4 = -(-N // 4)
    vs4 = F.pad(d.reshape(N, C), (0, Cpad - C, 0, 4 * N4 - N))
    vs4 = vs4.reshape(4, N4, Cpad).contiguous()
    # the kernels' layouts, once per model (the plain versions read vs4)
    on_card = vs4.device.type == "cuda"
    wts = scale.cpu().numpy()[:, None] / 64.0 \
        * (1.0 / 128.0) ** np.arange(N_SLICES)[None, :]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=_F64, device=dev)
    return PackedScanModel(
        trait_binary=model.trait_binary,
        tau=model.tau,
        V=t(V),
        XWX=t(X.T @ WX),
        wr=t(X.T @ r),
        u3=t(XV @ np.ones(N)),
        v3=t(WX.T @ np.ones(N)),
        sum_r=t(r.sum()),
        sum_w=t(W.sum()),
        var_ratio=model.var_ratio,
        n_cov=K,
        vs4=vs4,
        vs4k=operand_2bit(vs4) if on_card else None,
        vsk=operand(vs4.view(-1, Cpad)[:N]) if on_card else None,
        wts=t(wts),
        dense=model,
    )


def _contract(pm: PackedScanModel, payload) -> torch.Tensor:
    """The block's three indicator contractions, f64 [B, 3, Cpad], by the
    payload's route (2-bit -> B3, int8 -> B4, sparse -> B5 then B4), the
    kernels over the model's layouts of its slices."""
    if isinstance(payload, tuple):
        entries, row_ptr = payload
        payload = decode_codes(entries, row_ptr, row_ptr.shape[0] - 1,
                               pm.V.shape[1])
    if payload.dtype == torch.int8:
        return indicator_dot(payload, pm.vs, pm.vsk)
    return indicator_dot_2bit(payload, pm.vs4, pm.vs4k)


def _dot_last(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k a[..., k] * w[..., k]`` (broadcast), added in k order by
    elementwise operations alone, so that a variant's result does not
    depend on how many rows its block holds (a library's matrix product
    may block, and so sum, differently at another row count): a block split
    over devices scores bit for bit as the whole block does."""
    out = a[..., 0] * w[..., 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k] * w[..., k]
    return out


def _packed_phase1(pm: PackedScanModel, params: ScanParams, payload):
    """Contraction + per-variant moment algebra.

    ``payload`` is one block on one of three routes: the planar 2-bit
    block, uint8 [B, N4] (``pack_codes_2bit`` with missing retained as 3;
    byte j bit-pair p = sample p*N4+j); int8 codes [B, N] (3 = missing);
    or the gap-coded ``(entries, row_ptr)`` stream of
    ``ops/sparse_codes``.  Padded samples beyond N contribute nothing
    because their ``vs4`` rows are zero; all-missing rows come out invalid.
    Every step after the contraction is per variant and elementwise
    (:func:`_dot_last`), so a variant's statistics do not depend on its
    block's row count.
    """
    N = pm.V.shape[1]               # true sample count
    K = pm.n_cov
    R = pm.V.shape[0]

    Y3 = _contract(pm, payload)                          # f64 [B, 3, Cpad]
    B = Y3.shape[0]
    Y3 = Y3[:, :, :R * N_SLICES].reshape(B, 3, R, N_SLICES)
    Y3 = _dot_last(Y3, pm.wts)                           # [B, 3, R]
    Y0, Ym, Y2 = Y3[:, 0], Y3[:, 1], Y3[:, 2]

    ac = Y0[:, 0]
    n_miss = Ym[:, 0]
    a1, a2 = Y0[:, 1], Ym[:, 1]               # r' g0, r' m
    b3, b2 = Y0[:, 2], Ym[:, 2]               # W' g0, W' m
    bg2 = Y2[:, 2]                            # W' g2
    u1 = Y0[:, 3:3+K]                         # XV g0       [B, K]
    u2 = Ym[:, 3:3+K]                         # XV m
    v1 = Y0[:, 3+K:3+2*K]                     # (X'W) g0
    v2 = Ym[:, 3+K:3+2*K]                     # (X'W) m

    num = (N - n_miss)
    af = ac / (2.0 * num)
    mean = ac / num
    flip = af > 0.5
    mac = torch.minimum(ac, 2.0 * num - ac)
    maf = torch.minimum(af, 1.0 - af)
    valid = _valid_mask(params, num, maf, mac, n_miss / N)

    # affine map g = s*(g0 + mean*m) + t;  unflipped (1, 0), flipped (-1, 2)
    s = torch.where(flip, -1.0, 1.0).to(_F64)
    t = torch.where(flip, 2.0, 0.0).to(_F64)
    tau_c = t / s                                        # 0 or -2

    # S = r' L(g) = s*[ (a1 - wr.u1) + mean*(a2 - wr.u2) ] + t*(sum_r - wr.u3)
    wr_u1 = _dot_last(u1, pm.wr)
    wr_u2 = _dot_last(u2, pm.wr)
    wr_u3 = torch.dot(pm.u3, pm.wr)
    S = s * ((a1 - wr_u1) + mean * (a2 - wr_u2)) + t * (pm.sum_r - wr_u3)

    # var = sum W (q - X c)^2, q = g0 + mean*m + tau_c, c = u1+mean*u2+tau_c*u3
    c = u1 + mean[:, None] * u2 + tau_c[:, None] * pm.u3[None, :]  # [B, K]
    Wq2 = (b3 + 2.0 * bg2) + mean**2 * b2 + tau_c**2 * pm.sum_w \
        + 2.0 * tau_c * b3 + 2.0 * tau_c * mean * b2
    XWq = v1 + mean[:, None] * v2 + tau_c[:, None] * pm.v3[None, :]
    var = Wq2 - 2.0 * _dot_last(c, XWq) \
        + _dot_last(c, _dot_last(c[:, None, :], pm.XWX[None]))

    return dict(valid=valid, af=af, mac=mac, num=num, flip=flip,
                S=S, var=var)


def score_stats_binary_packed(pm: PackedScanModel, params: ScanParams,
                              payload) -> ScoreStats:
    """Phase-1 binary score test from one block on any of the three
    routes (see :func:`_packed_phase1`): chi-square p-values + SPA flags,
    float64."""
    m = _packed_phase1(pm, params, payload)
    return binary_stats(pm.dense, params, m["valid"], m["af"], m["mac"],
                        m["num"], m["flip"], m["S"], m["var"])


def score_stats_quant_packed(pm: PackedScanModel, params: ScanParams,
                             payload) -> ScoreStats:
    """Phase-1 quantitative score test from one block on any of the three
    routes (no SPA).  ``pack_scan_model`` uses W = 1 for a quantitative
    model, so ``var`` is sum g_tilde^2 (``single_test_quant``,
    src/saige_main.cpp:189-276)."""
    m = _packed_phase1(pm, params, payload)
    return quant_stats(pm.dense, m["valid"], m["af"], m["mac"], m["num"],
                       m["flip"], m["S"], m["var"])


# ---------------------------------------------------------------------------
# Device-side burden collapse: unit codes ship once (sparse or 2-bit), the
# weighted burden rows are built ON DEVICE and scored in the same call —
# the host never materializes or uploads [rows, N] f64.


def _burden_rows(codes: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 C: torch.Tensor) -> torch.Tensor:
    """Weighted burden rows from int8 codes.

    codes: int8 [S, N] (3 = missing); A, Bm: f64 [R, S] per-row SNP
    coefficients (A on the zero-filled dosage, Bm on the missing
    indicator); C: f64 [R] constants.  Row r = A[r] @ G0 + Bm[r] @ M +
    C[r] — the affine form of the reference's per-SNP mean-impute +
    minor-flip + weight collapse (``ds_mat_burden``,
    src/saige_main.cpp:526-610).

    The JAX package slices A and Bm into signed 7-bit integers for exact
    bf16 products on the TPU, whose f64 is emulated; the H100 has native
    f64, so this is one f64 product per sample chunk.  Each row is then
    within a few ulps of the exact affine value, as the slice form is.
    """
    S, N = codes.shape
    rows = torch.empty(A.shape[0], N, dtype=_F64, device=codes.device)
    for j0 in range(0, N, _BURDEN_N_CHUNK):
        c = codes[:, j0:j0 + _BURDEN_N_CHUNK]
        g0 = torch.where(c == 3, 0, c).to(_F64)
        rows[:, j0:j0 + _BURDEN_N_CHUNK] = A @ g0 + Bm @ (c == 3).to(_F64)
    return rows + C[:, None]


def burden_score_packed(model: ScanModel, params: ScanParams, payload,
                        A: torch.Tensor, Bm: torch.Tensor,
                        C: torch.Tensor, binary: bool = True) -> ScoreStats:
    """Collapse + score burden rows on the device, with the binary or the
    quantitative (``binary=False``) score test.

    ``payload`` is the unit batch's codes: the 2-bit planar uint8
    [S, ceil(N/4)] or the gap-coded ``(entries, row_ptr)`` transport
    (decoded by kernel B5).  The resulting [R, N] f64 burden rows feed the
    dense score test (the reference re-runs ``single_test_bin`` on each
    collapsed vector, src/saige_main.cpp:872-897)."""
    N = model.XV.shape[1]
    if isinstance(payload, tuple):
        entries, row_ptr = payload
        codes = decode_codes(entries, row_ptr, row_ptr.shape[0] - 1, N)
    else:
        pi = payload.to(torch.int32)
        codes = torch.cat([(pi >> (2 * p)) & 3 for p in range(4)],
                          dim=1)[:, :N].to(torch.int8)
    fn = score_stats_binary if binary else score_stats_quant
    return fn(model, params, _burden_rows(codes, A, Bm, C))
