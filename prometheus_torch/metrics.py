"""Image-quality metrics: PSNR, SSIM, and the no-reference BRISQUE and NIQE
scores, in numpy and scipy (``prometheus_tpu/metrics.py``, a copy that
imports nothing of the JAX package).

PSNR and SSIM are exact. BRISQUE and NIQE are built on the MSCN
(mean-subtracted contrast-normalised) natural-scene-statistics features;
their calibrated scores need pretrained assets (an SVR model for BRISQUE, a
pristine-corpus MVG for NIQE such as ``niqe_image_params.mat``). Without
them ``brisque`` and ``niqe`` return a documented NSS-deviation proxy on the
same features, so comparisons between methods stay meaningful; with them,
the calibrated scores. NIQE's half-scale image is OpenCV's ``INTER_CUBIC``
resize, done here by ``half_scale_cubic`` in PyTorch (no OpenCV).

The generalized-Gaussian fits search a fixed grid of shapes whose gamma
ratios are computed once and cached (the JAX package recomputes them on
every fit; the numbers are the same).
"""
from __future__ import annotations

import functools
from math import gamma as G

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Reference metrics
# ---------------------------------------------------------------------------

def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(pred, np.float64) - gt) ** 2))
    return 10.0 * np.log10(data_range**2 / max(mse, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    k2 = np.outer(k, k)
    return k2 / k2.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """valid-mode 2D correlation via FFT-free sliding windows."""
    kh, kw = kernel.shape
    h, w = img.shape
    out = np.zeros((h - kh + 1, w - kw + 1), np.float64)
    # separable when rank-1 (gaussian): split for speed
    u, s, vt = np.linalg.svd(kernel)
    k1 = u[:, 0] * np.sqrt(s[0])
    k2 = vt[0] * np.sqrt(s[0])
    tmp = np.apply_along_axis(
        lambda r: np.convolve(r, k2[::-1], "valid"), 1, img)
    out = np.apply_along_axis(
        lambda c: np.convolve(c, k1[::-1], "valid"), 0, tmp)
    return out


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Single-scale SSIM (grayscale or mean over channels), 11x11 gaussian."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 3:
        return float(np.mean([ssim(pred[..., c], gt[..., c], data_range)
                              for c in range(pred.shape[-1])]))
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu1, mu2 = _filter2(pred, k), _filter2(gt, k)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = _filter2(pred * pred, k) - mu1_sq
    s2 = _filter2(gt * gt, k) - mu2_sq
    s12 = _filter2(pred * gt, k) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return float(np.mean(num / den))


# ---------------------------------------------------------------------------
# NSS features (shared by BRISQUE / NIQE)
# ---------------------------------------------------------------------------

def _to_gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        if img.shape[0] in (1, 3) and img.shape[0] < img.shape[-1]:
            img = np.moveaxis(img, 0, -1)
        img = img @ np.asarray([0.299, 0.587, 0.114])[: img.shape[-1]]
    if img.max() <= 1.5:  # classical NSS pipelines run on [0, 255] intensity
        img = img * 255.0
    return img


def mscn(img: np.ndarray, sigma: float = 7.0 / 6.0) -> np.ndarray:
    """Mean-subtracted contrast-normalized coefficients."""
    k = _gaussian_kernel(7, sigma)
    pad = 3
    padded = np.pad(img, pad, mode="reflect")
    mu = _filter2(padded, k)
    var = _filter2(padded * padded, k) - mu**2
    sd = np.sqrt(np.maximum(var, 0))
    return (img - mu) / (sd + 1.0)


def _readonly(*arrays):
    for a in arrays:
        a.flags.writeable = False
    return arrays


@functools.cache
def _ggd_table():
    """The GGD shape grid and ``G(1/g) G(3/g) / G(2/g)^2`` on it."""
    gam = np.arange(0.2, 10.001, 0.001)
    r_gam = np.asarray([(G(1 / g) * G(3 / g)) / (G(2 / g) ** 2) for g in gam])
    return _readonly(gam, r_gam)


@functools.cache
def _aggd_table(stop: float):
    """The AGGD shape grid ``arange(0.2, stop, 0.001)`` and ``G(2/g)^2 /
    (G(1/g) G(3/g))`` on it."""
    gam = np.arange(0.2, stop, 0.001)
    r_gam = np.asarray([(G(2 / g) ** 2) / (G(1 / g) * G(3 / g)) for g in gam])
    return _readonly(gam, r_gam)


def _ggd_params(x: np.ndarray):
    """Estimate generalized-gaussian shape (alpha) and variance."""
    gam, r_gam = _ggd_table()
    sigma_sq = np.mean(x**2)
    e = np.mean(np.abs(x))
    rho = sigma_sq / max(e**2, 1e-12)
    alpha = gam[np.argmin(np.abs(rho - r_gam))]
    return alpha, sigma_sq


def _aggd_params(x: np.ndarray):
    """Asymmetric GGD fit -> (alpha, mean, left var, right var)."""
    gam, r_gam = _aggd_table(10.001)
    left = x[x < 0]
    right = x[x >= 0]
    sl = np.sqrt(np.mean(left**2)) if left.size else 1e-6
    sr = np.sqrt(np.mean(right**2)) if right.size else 1e-6
    gamma_hat = sl / max(sr, 1e-12)
    rhat = np.mean(np.abs(x)) ** 2 / max(np.mean(x**2), 1e-12)
    rhat_norm = rhat * (gamma_hat**3 + 1) * (gamma_hat + 1) / \
        (gamma_hat**2 + 1) ** 2
    alpha = gam[np.argmin((r_gam - rhat_norm) ** 2)]
    const = np.sqrt(G(1 / alpha) / G(3 / alpha))
    mean = (sr - sl) * (G(2 / alpha) / G(1 / alpha)) * const
    return alpha, mean, sl**2, sr**2


def brisque_features(img: np.ndarray) -> np.ndarray:
    """36-dim BRISQUE NSS feature vector (2 scales x 18 features)."""
    gray = _to_gray(img)
    feats = []
    for scale in range(2):
        m = mscn(gray)
        alpha, sigma_sq = _ggd_params(m.ravel())
        feats += [alpha, sigma_sq]
        for (dy, dx) in [(0, 1), (1, 0), (1, 1), (1, -1)]:
            shifted = np.roll(np.roll(m, dy, axis=0), dx, axis=1)
            pair = (m * shifted).ravel()
            feats += list(_aggd_params(pair))
        gray = gray[::2, ::2]
    return np.asarray(feats)


# Empirical pristine anchors for the proxy score, measured on 1/f-spectrum
# (natural-statistics) images through this exact MSCN pipeline: GGD shape
# ~2.3, MSCN variance ~0.6. Distortions (blur, flatness, compression)
# collapse the MSCN variance, so the log-variance term carries most weight.
_PRISTINE_ALPHA = 2.3
_PRISTINE_SIGMA = 0.6


def _nss_deviation(alpha: float, sigma_sq: float) -> float:
    dv = abs(np.log(max(sigma_sq, 1e-6) / _PRISTINE_SIGMA))
    da = abs(alpha - _PRISTINE_ALPHA) / _PRISTINE_ALPHA
    return 0.8 * dv / 3.0 + 0.2 * da


# ---------------------------------------------------------------------------
# Official-asset paths: libsvm SVR (BRISQUE 'allmodel') and NIQE pristine MVG
# ---------------------------------------------------------------------------

def load_svr_model(path: str) -> dict:
    """Parse a libsvm epsilon-SVR model file (the official BRISQUE
    ``allmodel`` format): header (svm_type/kernel_type/gamma/rho), then
    support vectors as ``coef idx:val ...`` lines after ``SV``."""
    header, sv_coef, svs = {}, [], []
    with open(path) as fp:
        lines = [ln.strip() for ln in fp]
    i = 0
    while i < len(lines) and lines[i] != "SV":
        parts = lines[i].split()
        if parts:
            header[parts[0]] = parts[1:] if len(parts) > 2 else \
                (parts[1] if len(parts) == 2 else True)
        i += 1
    n_feat = 0
    for ln in lines[i + 1:]:
        if not ln:
            continue
        parts = ln.split()
        sv_coef.append(float(parts[0]))
        pairs = [p.split(":") for p in parts[1:]]
        n_feat = max(n_feat, max(int(ix) for ix, _ in pairs))
        svs.append({int(ix): float(v) for ix, v in pairs})
    sv = np.zeros((len(svs), n_feat))
    for r, d in enumerate(svs):
        for ix, v in d.items():
            sv[r, ix - 1] = v
    return {"gamma": float(header.get("gamma", 1.0)),
            "rho": float(header.get("rho", 0.0)),
            "coef": np.asarray(sv_coef), "sv": sv}


def load_feature_range(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse a libsvm ``svm-scale`` range file (BRISQUE ``allrange``):
    lines ``idx min max`` after the 'x / lower upper' header."""
    lo, hi = {}, {}
    with open(path) as fp:
        for ln in fp:
            parts = ln.split()
            if len(parts) == 3 and parts[0].isdigit():
                lo[int(parts[0])] = float(parts[1])
                hi[int(parts[0])] = float(parts[2])
    n = max(lo)
    lo_a = np.asarray([lo.get(i + 1, 0.0) for i in range(n)])
    hi_a = np.asarray([hi.get(i + 1, 1.0) for i in range(n)])
    return lo_a, hi_a


def svr_predict(model: dict, x: np.ndarray) -> float:
    """RBF epsilon-SVR decision value: sum_i coef_i K(sv_i, x) - rho."""
    d2 = np.sum((model["sv"] - x[None, : model["sv"].shape[1]]) ** 2, axis=1)
    k = np.exp(-model["gamma"] * d2)
    return float(model["coef"] @ k - model["rho"])


def brisque(img: np.ndarray, svr_params: str | None = None,
            feature_range: str | None = None) -> float:
    """No-reference quality (lower = better).

    With ``svr_params`` (the official libsvm ``allmodel``, optionally plus
    the ``allrange`` scaling file) this computes the calibrated BRISQUE
    score; otherwise a documented NSS-deviation proxy on the same 36-dim
    features."""
    f = brisque_features(img)
    if svr_params is not None:
        model = load_svr_model(svr_params)
        if feature_range is not None:
            lo, hi = load_feature_range(feature_range)
            n = min(len(f), len(lo))
            f = f.copy()
            f[:n] = -1.0 + 2.0 * (f[:n] - lo[:n]) / np.maximum(
                hi[:n] - lo[:n], 1e-12)
        return svr_predict(model, f)
    d = 0.5 * (_nss_deviation(f[0], f[1]) + _nss_deviation(f[18], f[19]))
    return float(100.0 * d)


def _aggd_beta_params(x: np.ndarray):
    """AGGD fit in the NIQE parameterization -> ``(alpha, N, bl, br)`` where
    ``bl/br`` are the left/right SCALE (beta) parameters
    ``sqrt(G(1/a)/G(3/a)) * side_rms`` and ``N`` is the mean parameter —
    unlike the BRISQUE form (:func:`_aggd_params`), which carries side
    VARIANCES. The official NIQE assets were fit in this parameterization."""
    gam, r_gam = _aggd_table(10)      # the official release's exact grid
    left = x[x < 0]
    right = x[x >= 0]
    sl = np.sqrt(np.mean(left**2)) if left.size else 0.0
    sr = np.sqrt(np.mean(right**2)) if right.size else 0.0
    gamma_hat = sl / sr if sr != 0 else np.inf
    rhat = np.mean(np.abs(x)) ** 2 / max(np.mean(x**2), 1e-12)
    rhat_norm = rhat * (gamma_hat**3 + 1) * (gamma_hat + 1) / \
        (gamma_hat**2 + 1) ** 2 if np.isfinite(gamma_hat) else np.inf
    alpha = gam[np.argmin((r_gam - rhat_norm) ** 2)]
    const = np.sqrt(G(1 / alpha) / G(3 / alpha))
    bl, br = const * sl, const * sr
    n_mean = (br - bl) * (G(2 / alpha) / G(1 / alpha))
    return alpha, n_mean, bl, br


def _mscn_constant(img: np.ndarray, sigma: float = 7.0 / 6.0) -> np.ndarray:
    """MSCN with the official NIQE release's exact border handling: 7-tap
    separable gaussian via ``correlate1d(mode='constant')`` (zero padding)
    and ``sqrt(abs(var))`` — the reference metric script inherits these
    (the reference's ``paper/metric_scripts/compute_niqe.py:94-123``), and
    they differ measurably from reflect padding at patch borders."""
    from scipy.ndimage import correlate1d

    img = np.asarray(img, np.float32)
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * x**2 / sigma**2)
    k /= k.sum()
    mu = correlate1d(correlate1d(img, k, 0, mode="constant"), k, 1,
                     mode="constant")
    var = correlate1d(correlate1d(img * img, k, 0, mode="constant"), k, 1,
                      mode="constant")
    sd = np.sqrt(np.abs(var - mu * mu))
    return (img - mu) / (sd + 1.0)


def _niqe_patch_feats(m: np.ndarray) -> list[float]:
    """18 NIQE features of one MSCN patch, reference-script-exact
    (``compute_niqe.py:126-139``): AGGD-beta on the coefficients ->
    ``[alpha, (bl+br)/2]``, then per paired product (H, V, D1, D2)
    ``[alpha, N, bl, br]`` — EXCEPT the D1/D2 rows, which the vendored
    implementation emits as ``[alpha, N, bl, bl]`` (its lines 137-138; a
    long-standing quirk of the public python port). Replicated knowingly:
    the reference's published numbers were produced with it, so numeric
    parity requires it."""
    alpha_m, _, bl, br = _aggd_beta_params(m.ravel())
    feats = [alpha_m, (bl + br) / 2.0]
    for i, (dy, dx) in enumerate([(0, 1), (1, 0), (1, 1), (1, -1)]):
        shifted = np.roll(np.roll(m, dy, axis=0), dx, axis=1)
        a, n_m, l, r = _aggd_beta_params((m * shifted).ravel())
        feats += [a, n_m, l, l if i >= 2 else r]
    return feats


def half_scale_cubic(img: np.ndarray) -> np.ndarray:
    """OpenCV's ``resize(img, None, fx=0.5, fy=0.5, interpolation=
    INTER_CUBIC)`` of a float32 ``(H, W)`` image: bicubic (a = -0.75) with
    half-pixel centres, no antialiasing, the border replicated, each side
    ``round(n / 2)`` (half to even). Torch's bicubic at scale 0.5 gives
    ``floor(n / 2)``: where OpenCV rounds up, one replicated row or column
    is added first, which is what OpenCV's border reads anyway."""
    h, w = img.shape
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None, None]
    pad_h, pad_w = 2 * round(h / 2) - h, 2 * round(w / 2) - w
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, max(pad_w, 0), 0, max(pad_h, 0)), mode="replicate")
    out = F.interpolate(x, scale_factor=0.5, mode="bicubic",
                        align_corners=False, antialias=False,
                        recompute_scale_factor=False)
    return out[0, 0].numpy()


def niqe_features_patches(gray: np.ndarray, patch: int = 96) -> np.ndarray:
    """Official NIQE per-patch features, procedure-identical to the
    reference script (``compute_niqe.py:165-196``): crop to a multiple of
    ``patch``, bicubic half-scale (``half_scale_cubic``, OpenCV's
    ``INTER_CUBIC``), constant-border MSCN at both scales, 18 features per
    non-overlapping ``patch`` block at full scale + 18 per aligned
    ``patch/2`` block at half scale -> ``(n_patches, 36)``."""
    h, w = gray.shape
    gray = np.asarray(gray[:h - h % patch or None,
                           :w - w % patch or None], np.float32)
    half = half_scale_cubic(gray)
    m1 = _mscn_constant(gray).astype(np.float32)
    m2 = _mscn_constant(half).astype(np.float32)
    h, w = gray.shape
    p2 = patch // 2
    feats = []
    for y in range(0, h - patch + 1, patch):
        for x in range(0, w - patch + 1, patch):
            f = _niqe_patch_feats(m1[y:y + patch, x:x + patch])
            f += _niqe_patch_feats(m2[y // 2:y // 2 + p2,
                                      x // 2:x // 2 + p2])
            feats.append(f)
    return np.asarray(feats) if feats else np.zeros((0, 36))


def load_niqe_model(mat_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load the pristine MVG (``niqe_image_params.mat``: pop_mu, pop_cov)."""
    from scipy.io import loadmat

    m = loadmat(mat_path)
    mu = np.asarray(m["pop_mu"]).ravel()
    cov = np.asarray(m["pop_cov"])
    return mu, cov


def niqe(img: np.ndarray, model_params: str | None = None,
         patch: int = 32) -> float:
    """NIQE score (lower = better).

    With ``model_params`` (the official ``niqe_image_params.mat``) this is
    the calibrated NIQE: Mahalanobis distance between the pristine MVG and
    the test image's patch-feature MVG. Otherwise a documented NSS-deviation
    proxy."""
    gray = _to_gray(img)
    if model_params is not None:
        mu0, cov0 = load_niqe_model(model_params)
        p = 96 if min(gray.shape) >= 192 else max(
            32, (min(gray.shape) // 2) // 16 * 16)
        feats = niqe_features_patches(gray, patch=p)
        if feats.shape[0] < 2:
            feats = niqe_features_patches(gray, patch=max(16, p // 2))
        mu1 = feats.mean(0)
        cov1 = np.cov(feats, rowvar=False)
        n = min(len(mu0), len(mu1))
        d = mu0[:n] - mu1[:n]
        mid = (cov0[:n, :n] + cov1[:n, :n]) / 2.0
        return float(np.sqrt(max(
            d @ np.linalg.pinv(mid) @ d, 0.0)))
    h, w = gray.shape
    m = mscn(gray)
    feats = []
    for y in range(0, h - patch + 1, patch):
        for x in range(0, w - patch + 1, patch):
            blk = m[y : y + patch, x : x + patch]
            alpha, sigma_sq = _ggd_params(blk.ravel())
            feats.append([alpha, sigma_sq])
    if not feats:
        return 0.0
    feats = np.asarray(feats)
    devs = [_nss_deviation(a, s) for a, s in feats]
    return float(100.0 * np.mean(devs))


def clip_score(image_features: np.ndarray, text_features: np.ndarray) -> float:
    """Cosine-similarity CLIP score given precomputed (normalized) features."""
    a = image_features / np.linalg.norm(image_features, axis=-1, keepdims=True)
    b = text_features / np.linalg.norm(text_features, axis=-1, keepdims=True)
    return float(np.mean(np.sum(a * b, axis=-1)))
