"""SOG compressed splat format, PlayCanvas SuperSplat-compatible
(counterpart of lichtfeld_studio_tpu/io/sog.py: the same layout, meta.json
keys and ZIP names).

Reference: writer src/core/sogs.cpp:335-764, reader src/loader/formats/
sogs.cpp:102-420. Layout (version 2):

* texture dims: width = ceil(sqrt(N)/4)*4, height = ceil(N/width/4)*4, RGBA
* means: signed-log transform, normalized to 16-bit, split into
  means_l.webp / means_u.webp (low/high bytes)
* quats: normalized, largest-component-dropped packing (remaining three
  scaled by sqrt(2) into 8 bits), index stored as alpha 252+i -> quats.webp
* scales: per-component 1-D k-means (k=256) codebook + labels -> scales.webp
* sh0: 1-D k-means codebook + labels, opacity in alpha -> sh0.webp
* shN: N-D k-means palette (<=64*1024 entries) + 256-entry 1-D codebook over
  centroid values -> shN_centroids.webp + shN_labels.webp
* meta.json with codebooks/mins/maxs; bundle = ZIP with .sog extension
* splats are morton-ordered (kernels/morton_encoding.cu) for locality

WebP here is encoded LOSSLESSly via PIL (the reference uses libwebp
lossless), so roundtrips are exact. A PIL without its WebP codec raises; no
other image format stands in. The k-means runs on torch tensors
(ops/kmeans.py) on `device`: the first GPU unless the caller passes one.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

import torch

from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud
from lichtfeld_studio_tpu_torch.ops.kmeans import kmeans_1d, kmeans_nd


# ----------------------------------------------------------------- helpers
def morton_encode(points: np.ndarray) -> np.ndarray:
    """10-bit-per-axis 3D morton codes over the normalized bbox
    (kernels/morton_encoding.cu:17-28)."""
    mins = points.min(axis=0)
    maxs = points.max(axis=0)
    q = ((points - mins) / np.maximum(maxs - mins, 1e-12) * 1023.0).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _log_transform(v: np.ndarray) -> np.ndarray:
    """signed log (sogs.cpp:55-57)."""
    return np.sign(v) * np.log(np.abs(v) + 1.0)


def _inv_log_transform(v: np.ndarray) -> np.ndarray:
    return np.sign(v) * (np.exp(np.abs(v)) - 1.0)


def _pack_quats(rot: np.ndarray) -> np.ndarray:
    """Largest-component quat packing (sogs.cpp:60-143). rot [N,4] wxyz
    normalized. Returns uint8 [N,4]."""
    n = rot.shape[0]
    q = rot / np.maximum(np.linalg.norm(rot, axis=1, keepdims=True), 1e-12)
    max_idx = np.argmax(np.abs(q), axis=1)
    sign = np.sign(q[np.arange(n), max_idx])
    sign[sign == 0] = 1.0
    q = q * sign[:, None] * np.sqrt(2.0)

    out = np.empty((n, 4), np.uint8)
    # indices of the three stored components per max_idx
    store = {0: [1, 2, 3], 1: [0, 2, 3], 2: [0, 1, 3], 3: [0, 1, 2]}
    for mi, cols in store.items():
        rows = max_idx == mi
        vals = q[rows][:, cols]
        out[rows, :3] = np.clip((vals * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    out[:, 3] = (252 + max_idx).astype(np.uint8)
    return out


def _unpack_quats(data: np.ndarray) -> np.ndarray:
    """Inverse of _pack_quats. data uint8 [N,4] -> [N,4] wxyz."""
    n = data.shape[0]
    max_idx = data[:, 3].astype(np.int32) - 252
    vals = (data[:, :3].astype(np.float32) / 255.0 - 0.5) * 2.0 / np.sqrt(2.0)
    q = np.zeros((n, 4), np.float32)
    store = {0: [1, 2, 3], 1: [0, 2, 3], 2: [0, 1, 3], 3: [0, 1, 2]}
    for mi, cols in store.items():
        rows = max_idx == mi
        q[np.ix_(rows, cols)] = vals[rows]
        missing = np.sqrt(np.clip(1.0 - np.sum(q[rows] ** 2, axis=1), 0.0, 1.0))
        q[rows, mi] = missing
    return q


def _require_webp() -> None:
    from PIL import features

    if not features.check("webp"):
        raise RuntimeError("SOG needs PIL's WebP codec, and PIL.features.check('webp') is "
                           "false in this installation")


def _webp_bytes(data: np.ndarray, w: int, h: int) -> bytes:
    from PIL import Image

    img = Image.fromarray(data.reshape(h, w, 4), "RGBA")
    buf = io.BytesIO()
    img.save(buf, "WEBP", lossless=True, quality=100)
    return buf.getvalue()


def _webp_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img)


def _cluster_1d(values: np.ndarray, k: int, iterations: int, device):
    c, l = kmeans_1d(torch.from_numpy(np.ascontiguousarray(values)).to(device), k=k,
                     iterations=iterations)
    return c.cpu().numpy(), l.cpu().numpy()


def _cluster_nd(points: np.ndarray, k: int, iterations: int, device):
    c, l = kmeans_nd(torch.from_numpy(np.ascontiguousarray(points)).to(device), k=k,
                     iterations=iterations)
    return c.cpu().numpy(), l.cpu().numpy()


# ----------------------------------------------------------------- writer
def write_sog(pc: PointCloud, output_path: str | Path, kmeans_iterations: int = 10,
              device: str | torch.device | None = None) -> None:
    """pc must carry full gaussian attributes (sh0/shN/opacity/scaling/
    rotation with activations NOT applied — scaling log, opacity logit,
    matching to_point_cloud()). The k-means runs on `device`, by default
    the first GPU (render.headless.default_device, which raises without
    one); the tests pass "cpu"."""
    if device is None:
        from lichtfeld_studio_tpu_torch.render.headless import default_device

        device = default_device()
    _require_webp()
    output_path = Path(output_path)
    n = pc.size
    assert n > 0, "no splats to write"

    width = int(np.ceil(np.sqrt(n) / 4.0)) * 4
    height = int(np.ceil(n / width / 4.0)) * 4

    means = pc.means.astype(np.float32)
    scales_raw = pc.scaling.astype(np.float32)  # log scales
    rot = pc.rotation.astype(np.float32)
    opacity = 1.0 / (1.0 + np.exp(-pc.opacity.astype(np.float32).reshape(-1)))
    sh0 = pc.sh0.reshape(n, 3).astype(np.float32)
    shN = pc.shN.astype(np.float32) if pc.shN is not None else np.zeros((n, 0, 3), np.float32)
    sh_coeffs = shN.shape[1]
    sh_degree = {0: 0, 3: 1, 8: 2, 15: 3}.get(sh_coeffs, 0)

    order = np.argsort(morton_encode(means))

    files: dict[str, bytes] = {}
    meta: dict = {"version": 2, "count": int(n), "width": width, "height": height}

    # --- means: 16-bit split log-transform ---
    mlog = _log_transform(means)
    mins, maxs = mlog.min(axis=0), mlog.max(axis=0)
    norm = (mlog[order] - mins) / np.maximum(maxs - mins, 1e-12)
    v16 = np.clip(norm * 65535.0, 0, 65535).astype(np.uint32)
    means_l = np.full((width * height, 4), 255, np.uint8)
    means_u = np.full((width * height, 4), 255, np.uint8)
    means_l[:n, :3] = (v16 & 0xFF).astype(np.uint8)
    means_u[:n, :3] = ((v16 >> 8) & 0xFF).astype(np.uint8)
    files["means_l.webp"] = _webp_bytes(means_l, width, height)
    files["means_u.webp"] = _webp_bytes(means_u, width, height)
    meta["means"] = {
        "mins": [float(x) for x in mins],
        "maxs": [float(x) for x in maxs],
        "files": ["means_l.webp", "means_u.webp"],
    }

    # --- quats ---
    quats = np.full((width * height, 4), 255, np.uint8)
    quats[:n] = _pack_quats(rot[order])
    files["quats.webp"] = _webp_bytes(quats, width, height)
    meta["quats"] = {"files": ["quats.webp"]}

    # --- scales: 1-D k-means over all 3 components (column-major flatten) ---
    scales_flat = scales_raw.T.reshape(-1)  # [3N]: x then y then z
    sc_centroids, sc_labels = _cluster_1d(scales_flat, 256, kmeans_iterations, device)
    scales_img = np.full((width * height, 4), 255, np.uint8)
    for c in range(3):
        scales_img[:n, c] = sc_labels[c * n : (c + 1) * n][order].astype(np.uint8)
    files["scales.webp"] = _webp_bytes(scales_img, width, height)
    meta["scales"] = {"codebook": [float(x) for x in sc_centroids], "files": ["scales.webp"]}

    # --- sh0 + opacity ---
    col_flat = sh0.T.reshape(-1)
    c0_centroids, c0_labels = _cluster_1d(col_flat, 256, kmeans_iterations, device)
    sh0_img = np.zeros((width * height, 4), np.uint8)
    for c in range(3):
        sh0_img[:n, c] = c0_labels[c * n : (c + 1) * n][order].astype(np.uint8)
    sh0_img[:n, 3] = np.clip(255.0 * opacity[order], 0, 255).astype(np.uint8)
    files["sh0.webp"] = _webp_bytes(sh0_img, width, height)
    meta["sh0"] = {"codebook": [float(x) for x in c0_centroids], "files": ["sh0.webp"]}

    # --- shN palette (sogs.cpp:620-731) ---
    if sh_degree > 0:
        flat = shN.reshape(n, sh_coeffs * 3)
        palette_size = min(64 * 1024, max(1, int(2 ** np.floor(np.log2(max(n / 1024.0, 1))))) * 1024)
        palette_size = min(palette_size, n)
        centroids, labels = _cluster_nd(flat, palette_size, kmeans_iterations, device)
        cb_centroids, cb_labels = _cluster_1d(centroids.reshape(-1), 256, kmeans_iterations, device)

        cw = 64 * sh_coeffs
        ch = (palette_size + 63) // 64
        cbuf = np.full((cw * ch, 4), 255, np.uint8)
        # pixel i * coeffs + j holds entry i's coefficient j, channel c in
        # byte c, as read_sog (and SuperSplat) read it. `flat` is
        # coefficient-major ([i, j * 3 + c]), so the labels are already in
        # pixel order. (The JAX package's writer indexes them channel-major,
        # [i, c * coeffs + j], which its own reader does not undo.)
        cbuf[: palette_size * sh_coeffs, :3] = cb_labels.reshape(-1, 3).astype(np.uint8)
        files["shN_centroids.webp"] = _webp_bytes(cbuf, cw, ch)

        lbuf = np.full((width * height, 4), 255, np.uint8)
        lab = labels[order]
        lbuf[:n, 0] = (lab & 0xFF).astype(np.uint8)
        lbuf[:n, 1] = ((lab >> 8) & 0xFF).astype(np.uint8)
        lbuf[:n, 2] = 0
        files["shN_labels.webp"] = _webp_bytes(lbuf, width, height)

        meta["shN"] = {
            "codebook": [float(x) for x in cb_centroids[:256]],
            "palette_size": int(palette_size),
            "bands": int(sh_degree),
            "coeffs": int(sh_coeffs),
            "files": ["shN_centroids.webp", "shN_labels.webp"],
        }

    # --- emit: .sog zip bundle or directory ---
    meta_bytes = json.dumps(meta, indent=1).encode()
    if output_path.suffix == ".sog":
        with zipfile.ZipFile(output_path, "w", zipfile.ZIP_STORED) as z:
            z.writestr("meta.json", meta_bytes)
            for name, data in files.items():
                z.writestr(name, data)
    else:
        output_path.mkdir(parents=True, exist_ok=True)
        (output_path / "meta.json").write_bytes(meta_bytes)
        for name, data in files.items():
            (output_path / name).write_bytes(data)


# ----------------------------------------------------------------- reader
def read_sog(path: str | Path) -> PointCloud:
    """Decode a .sog bundle or directory back to a PointCloud with raw
    (log-scale / logit-opacity) attributes (src/loader/formats/sogs.cpp).
    Host numpy only."""
    _require_webp()
    path = Path(path)
    if path.is_file():
        with zipfile.ZipFile(path) as z:
            blobs = {name: z.read(name) for name in z.namelist()}
    else:
        blobs = {p.name: p.read_bytes() for p in path.iterdir()}
    meta = json.loads(blobs["meta.json"])
    n = meta["count"]
    w, h = meta["width"], meta["height"]

    def img(name):
        return _webp_decode(blobs[name]).reshape(-1, 4)[: w * h]

    lo = img(meta["means"]["files"][0]).astype(np.uint32)
    hi = img(meta["means"]["files"][1]).astype(np.uint32)
    v16 = (lo[:n, :3] | (hi[:n, :3] << 8)).astype(np.float32) / 65535.0
    mins = np.asarray(meta["means"]["mins"], np.float32)
    maxs = np.asarray(meta["means"]["maxs"], np.float32)
    means = _inv_log_transform(v16 * (maxs - mins) + mins)

    rot = _unpack_quats(img(meta["quats"]["files"][0])[:n])

    sc_cb = np.asarray(meta["scales"]["codebook"], np.float32)
    sc = img(meta["scales"]["files"][0])[:n, :3]
    scaling = sc_cb[sc.astype(np.int32)]

    c0_cb = np.asarray(meta["sh0"]["codebook"], np.float32)
    s0img = img(meta["sh0"]["files"][0])[:n]
    sh0 = c0_cb[s0img[:, :3].astype(np.int32)].reshape(n, 1, 3)
    opacity = s0img[:, 3].astype(np.float32) / 255.0
    eps = 1e-6
    opacity = np.clip(opacity, eps, 1 - eps)
    opacity_logit = np.log(opacity / (1 - opacity)).reshape(n, 1)

    if "shN" in meta:
        coeffs = meta["shN"]["coeffs"]
        palette = meta["shN"]["palette_size"]
        cb = np.asarray(meta["shN"]["codebook"], np.float32)
        cw = 64 * coeffs
        ch = (palette + 63) // 64
        cimg = _webp_decode(blobs[meta["shN"]["files"][0]]).reshape(-1, 4)[: cw * ch]
        # entry i's coefficients are pixels i * coeffs .. i * coeffs + coeffs - 1
        idxs = cimg[: palette * coeffs, :3].astype(np.int32)
        centroids = cb[idxs].reshape(palette, coeffs, 3)
        limg = img(meta["shN"]["files"][1])[:n]
        labels = limg[:, 0].astype(np.int32) | (limg[:, 1].astype(np.int32) << 8)
        shN = centroids[np.clip(labels, 0, palette - 1)]
    else:
        shN = np.zeros((n, 0, 3), np.float32)

    return PointCloud(
        means=means.astype(np.float32),
        sh0=sh0,
        shN=shN,
        opacity=opacity_logit.astype(np.float32),
        scaling=scaling.astype(np.float32),
        rotation=rot,
    )


def is_sog(path: str | Path) -> bool:
    p = Path(path)
    if p.suffix == ".sog" and p.is_file():
        return True
    return p.is_dir() and (p / "meta.json").exists() and (p / "means_l.webp").exists()
