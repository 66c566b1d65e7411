"""The seeded stand-in for a MipNeRF360-style capture, written as a user's
dataset: a COLMAP text model, one JPEG per view and a warm-start PLY.

Everything is made from the run's seed, the gaussians and the images on the
device with a torch.Generator in a few large calls. Nothing here imports the
program: the files are what a user would hand the trainer (`-d <dataset>
--init-ply <ply>`), and the reference reads the same files.

Layout of a configuration's `dataset` and `scene` blocks: see
port_bench/configs/*.json.
"""

from __future__ import annotations

import math
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SEED_MASK = (1 << 63) - 1
MARK = "complete"  # written last: a directory without it is rebuilt


def seed_of(seed: int, salt: int = 0) -> int:
    """A non-negative 63-bit seed for numpy and torch from any whole number."""
    return (int(seed) * 0x9E3779B1 + salt) & SEED_MASK


# ----------------------------------------------------------------------
# Cameras
# ----------------------------------------------------------------------
def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """COLMAP world-to-camera (R, T) of a camera at `eye` looking at
    `target` (x right, y down, z forward), in float64."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    down /= np.linalg.norm(down)
    r = np.stack([right, down, fwd], axis=0)
    return r, -r @ eye


def ring_cameras(ds: dict, seed: int) -> list[dict]:
    """The capture's views: one ring round the scene's centre, jittered from
    the seed. Each view: R, T (float64), its name."""
    rng = np.random.default_rng(seed_of(seed, 1))
    n = ds["views"]
    cams = []
    for i in range(n):
        yaw = 2.0 * math.pi * i / n + rng.normal(0.0, 0.01)
        radius = ds["ring_radius"] + float(np.clip(rng.normal(0.0, 0.25), -0.6, 0.6))
        height = ds["ring_height"] + float(np.clip(rng.normal(0.0, 0.25), -0.6, 0.6))
        eye = np.array([radius * math.cos(yaw), radius * math.sin(yaw), height])
        target = np.array([0.0, 0.0, ds["target_height"]]) + rng.normal(0.0, 0.1, 3)
        r, t = look_at(eye, target)
        cams.append({"R": r, "T": t, "name": f"view_{i:04d}.jpg"})
    return cams


def orbit_cameras(view: dict, seed: int) -> list[dict]:
    """A viewer's orbit: `cameras` views evenly round the ring at the
    traffic's radius and height, the start angle from the seed."""
    rng = np.random.default_rng(seed_of(seed, 2))
    start = rng.uniform(0.0, 2.0 * math.pi)
    out = []
    for k in range(view["cameras"]):
        yaw = start + 2.0 * math.pi * k / view["cameras"]
        eye = np.array([view["radius"] * math.cos(yaw), view["radius"] * math.sin(yaw),
                        view["eye_height"]])
        r, t = look_at(eye, np.array([0.0, 0.0, view["target_height"]]))
        out.append({"R": r, "T": t, "name": f"orbit_{k}"})
    return out


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) quaternion of a rotation matrix."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = r.flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


# ----------------------------------------------------------------------
# Gaussians
# ----------------------------------------------------------------------
def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def make_splats(scene: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The warm-start model at the cap, float32 on `device`: means [N, 3],
    sh0 [N, 1, 3], shN [N, K-1, 3], scaling (log) [N, 3], rotation (unit
    wxyz) [N, 4], opacity (logit) [N, 1]. Group by group, a few large
    draws each from one generator."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 3))
    n = scene["gaussians"]
    groups = scene["groups"]
    counts = [int(round(grp["share"] * n)) for grp in groups]
    counts[-1] = n - sum(counts[:-1])
    f32 = dict(dtype=torch.float32, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    means, log_s = [], []
    for grp, m in zip(groups, counts):
        u = rand(m, 3)
        ang = 2.0 * math.pi * u[:, 0]
        if grp["kind"] == "ball":
            d = _unit(randn(m, 3))
            p = torch.tensor(grp["center"], **f32) + grp["radius"] * u[:, 1:2] ** (1 / 3) * d
        elif grp["kind"] == "disc":
            r = grp["radius"] * torch.sqrt(u[:, 1])
            p = torch.stack([r * torch.cos(ang), r * torch.sin(ang),
                             grp["thickness"] * randn(m)], dim=-1)
        elif grp["kind"] == "ring":
            r = torch.sqrt(grp["inner"] ** 2 + u[:, 1] * (grp["outer"] ** 2 - grp["inner"] ** 2))
            p = torch.stack([r * torch.cos(ang), r * torch.sin(ang), grp["height"] * u[:, 2]],
                            dim=-1)
        elif grp["kind"] == "shell":
            d = randn(m, 3)
            d[:, 2] = 0.6 * d[:, 2].abs()
            r = grp["inner"] + (grp["outer"] - grp["inner"]) * u[:, 1]
            p = r[:, None] * _unit(d)
        else:
            raise ValueError(f"unknown scene group kind {grp['kind']!r}")
        means.append(p)
        log_s.append(grp["log_scale"] + scene["log_scale_spread"] * randn(m, 3))
    k = (scene["sh_degree"] + 1) ** 2
    return {
        "means": torch.cat(means).contiguous(),
        "sh0": scene["sh0_std"] * randn(n, 1, 3),
        "shN": scene["shN_std"] * randn(n, k - 1, 3),
        "scaling": torch.cat(log_s).contiguous(),
        "rotation": _unit(randn(n, 4)),
        "opacity": scene["opacity_logit_mean"] + scene["opacity_logit_std"] * randn(n, 1),
    }


def ply_names(k_rest: int) -> list[str]:
    return (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
            + [f"f_rest_{i}" for i in range(3 * k_rest)] + ["opacity"]
            + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])


def write_ply(path: Path, s: dict[str, torch.Tensor]) -> None:
    """The 3DGS PLY layout (binary little endian; SH planes channel-major,
    raw log-scales, logit opacities, wxyz quaternions)."""
    n, k_rest = s["means"].shape[0], s["shN"].shape[1]
    cols = torch.cat([
        s["means"], torch.zeros_like(s["means"]), s["sh0"].transpose(1, 2).reshape(n, 3),
        s["shN"].transpose(1, 2).reshape(n, 3 * k_rest), s["opacity"], s["scaling"],
        s["rotation"]], dim=1).cpu().numpy().astype("<f4")
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in ply_names(k_rest)] + ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(cols.tobytes())


def read_ply(path: Path, device) -> dict[str, torch.Tensor]:
    """The inverse of write_ply, for a PLY of that layout."""
    with open(path, "rb") as f:
        names = []
        while (line := f.readline().decode("ascii").strip()) != "end_header":
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
        data = np.fromfile(f, dtype="<f4", count=n * len(names)).reshape(n, len(names))
    k_rest = sum(a.startswith("f_rest_") for a in names) // 3
    if names != ply_names(k_rest):
        raise ValueError(f"{path}: not the 3DGS layout")
    t = torch.from_numpy(data).to(device)
    c = 9 + 3 * k_rest
    return {
        "means": t[:, 0:3].contiguous(),
        "sh0": t[:, 6:9].reshape(n, 3, 1).transpose(1, 2).contiguous(),
        "shN": t[:, 9:c].reshape(n, 3, k_rest).transpose(1, 2).contiguous(),
        "opacity": t[:, c:c + 1].contiguous(),
        "scaling": t[:, c + 1:c + 4].contiguous(),
        "rotation": t[:, c + 4:c + 8].contiguous(),
    }


# ----------------------------------------------------------------------
# Images and the COLMAP model
# ----------------------------------------------------------------------
def make_images(ds: dict, n: int, seed: int, device, chunk: int = 8):
    """Yield (index, [H, W, 3] uint8 host array) for n procedural views:
    per view and channel a sum of eight random plane waves and fine noise.
    The content sets no step's cost; the model does."""
    g = torch.Generator(device=device).manual_seed(seed_of(seed, 4))
    h, w = ds["height"], ds["width"]
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] / w
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] / w
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        freq = 1.0 + 19.0 * torch.rand((m, 3, 8, 2), generator=g, device=device)
        phase = 2.0 * math.pi * torch.rand((m, 3, 8), generator=g, device=device)
        amp = 0.12 * torch.rand((m, 3, 8), generator=g, device=device)
        base = 0.25 + 0.5 * torch.rand((m, 3), generator=g, device=device)
        img = base[:, :, None, None].expand(m, 3, h, w).clone()
        for j in range(8):
            arg = (2.0 * math.pi * (freq[:, :, j, 0, None, None] * xx
                                    + freq[:, :, j, 1, None, None] * yy)
                   + phase[:, :, j, None, None])
            img += amp[:, :, j, None, None] * torch.sin(arg)
        img += 0.03 * torch.randn((m, 3, h, w), generator=g, device=device)
        u8 = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        host = u8.cpu().numpy()
        for k in range(m):
            yield i0 + k, host[k]


def camera_line(ds: dict) -> str:
    model = ds["camera_model"]
    params = [ds["fx"], ds["fy"], ds["width"] / 2.0, ds["height"] / 2.0]
    if model == "OPENCV_FISHEYE":
        params += list(ds["radial"])
    elif model != "PINHOLE":
        raise ValueError(f"the generator writes PINHOLE or OPENCV_FISHEYE, not {model}")
    return f"1 {model} {ds['width']} {ds['height']} " + " ".join(repr(float(p)) for p in params)


def write_colmap(sparse: Path, ds: dict, cams: list[dict], splats: dict, seed: int) -> None:
    sparse.mkdir(parents=True, exist_ok=True)
    (sparse / "cameras.txt").write_text("# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n"
                                        + camera_line(ds) + "\n")
    lines = ["# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME", "# POINTS2D[] as (X, Y, POINT3D_ID)"]
    for i, c in enumerate(cams):
        q = rotmat_to_qvec(c["R"])
        vals = " ".join(repr(float(v)) for v in (*q, *c["T"]))
        lines += [f"{i + 1} {vals} 1 {c['name']}", "0.0 0.0 -1"]
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    # the SfM cloud: a seeded subset of the model's centres, coloured by its DC term
    rng = np.random.default_rng(seed_of(seed, 5))
    pick = rng.choice(splats["means"].shape[0], ds["sfm_points"], replace=False)
    idx = torch.as_tensor(pick, device=splats["means"].device)
    xyz = splats["means"][idx].cpu().numpy()
    rgb = torch.clamp((0.5 + SH_C0 * splats["sh0"][idx, 0]) * 255.0, 0, 255).cpu().numpy()
    body = "\n".join(f"{i + 1} {x:.6f} {y:.6f} {z:.6f} {int(r)} {int(gg)} {int(b)} 0.5"
                     for i, ((x, y, z), (r, gg, b)) in enumerate(zip(xyz, rgb)))
    (sparse / "points3D.txt").write_text("# POINT3D_ID X Y Z R G B ERROR TRACK[]\n" + body + "\n")


def read_colmap_views(root: Path) -> tuple[dict, list[dict]]:
    """(intrinsics, views) of a dataset written by write_colmap, parsed the
    way COLMAP's text format says: views sorted by name, R from the
    quaternion, as float32."""
    sparse = root / "sparse" / "0"
    parts = [l.split() for l in (sparse / "cameras.txt").read_text().splitlines()
             if l.strip() and not l.startswith("#")][0]
    p = [float(v) for v in parts[4:]]
    intr = {"model": parts[1], "width": int(parts[2]), "height": int(parts[3]),
            "fx": p[0], "fy": p[1], "cx": p[2], "cy": p[3], "radial": p[4:]}
    rows = [l for l in (sparse / "images.txt").read_text().splitlines()
            if l.strip() and not l.startswith("#")]
    views = []
    for line in rows[0::2]:
        f = line.split()
        views.append({"R": qvec_to_rotmat([float(v) for v in f[1:5]]).astype(np.float32),
                      "T": np.array([float(v) for v in f[5:8]], np.float32), "name": f[9],
                      "path": str(root / "images" / f[9])})
    views.sort(key=lambda v: v["name"])
    return intr, views


def load_jpeg(path: str) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1] (PIL's decode, as a loader reads it)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32) / 255.0


# ----------------------------------------------------------------------
# The dataset directory
# ----------------------------------------------------------------------
def dataset_dir(cache: Path, config: dict, seed: int) -> Path:
    return cache / config["name"] / str(seed)


def build(cache: Path, config: dict, seed: int, device, *, views: bool = True) -> Path:
    """The dataset of (configuration, seed) under `cache`, made once:
    `init.ply` always, and with `views` the COLMAP model and the JPEGs.
    Other seeds' directories of the configuration are removed first, so
    the cache holds one dataset a configuration."""
    out = dataset_dir(cache, config, seed)
    if out.parent.exists():
        for other in out.parent.iterdir():
            if other != out:
                shutil.rmtree(other, ignore_errors=True)
    mark = out / (MARK + (".views" if views else ".ply"))
    if mark.exists() or (out / (MARK + ".views")).exists():
        return out
    out.mkdir(parents=True, exist_ok=True)
    splats = make_splats(config["scene"], seed, device)
    write_ply(out / "init.ply", splats)
    if views:
        ds = config["dataset"]
        cams = ring_cameras(ds, seed)
        write_colmap(out / "sparse" / "0", ds, cams, splats, seed)
        img_dir = out / "images"
        img_dir.mkdir(exist_ok=True)
        from PIL import Image

        def save(item):
            i, arr = item
            Image.fromarray(arr).save(img_dir / cams[i]["name"], quality=ds["jpeg_quality"])

        with ThreadPoolExecutor(4) as pool:
            list(pool.map(save, make_images(ds, len(cams), seed, device)))
    mark.write_text("ok\n")
    return out
