"""3DGS PLY read/write — byte-compatible with the reference exporter.

Reference: writer src/core/splat_data.cpp:113-170 (tinyply binary LE),
reader src/loader/formats/ply.cpp. Attribute schema from
SplatData::get_attribute_names (splat_data.cpp:402-418):
x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity scale_{0..2}
rot_{0..3}; SH planes are channel-major (all R coeffs, then G, then B),
raw (log-scale / logit-opacity / unnormalized-quat... quats normalized at
export) parameterizations on disk.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud


def write_ply(pc: PointCloud, path: str | Path) -> None:
    n = pc.size
    sh0 = pc.sh0.transpose(0, 2, 1).reshape(n, -1)  # [N,1,3] -> [N,3]
    shN = pc.shN.transpose(0, 2, 1).reshape(n, -1)  # [N,K-1,3] -> [N,3(K-1)]
    cols = [
        pc.means,
        pc.normals if pc.normals is not None else np.zeros_like(pc.means),
        sh0,
        shN,
        pc.opacity.reshape(n, -1),
        pc.scaling,
        pc.rotation,
    ]
    data = np.concatenate(cols, axis=1).astype("<f4")
    names = pc.attribute_names
    assert data.shape[1] == len(names), (data.shape, len(names))

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


def read_ply(path: str | Path) -> PointCloud:
    """Read a 3DGS splat PLY (or a plain xyz/rgb point cloud)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file (missing 'ply' magic)")
        header_lines = []
        while True:
            raw = f.readline()
            if not raw:  # EOF before end_header: corrupt/truncated header
                raise ValueError(f"{path}: truncated PLY header (no end_header)")
            line = raw.decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        n = 0
        props: list[tuple[str, str]] = []
        fmt = "binary_little_endian"
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                n = int(parts[2])
            elif parts[0] == "property" and parts[1] != "list":
                props.append((parts[2], parts[1]))
        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
            "short": "<i2", "ushort": "<u2", "char": "i1",
        }
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        dtype = np.dtype([(name, type_map[t]) for name, t in props])
        data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)

    name_set = {name for name, _ in props}
    means = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)

    pc = PointCloud(means=means)
    pc.attribute_names = [name for name, _ in props]

    if "f_dc_0" in name_set:
        sh0 = np.stack([data[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
        pc.sh0 = sh0.reshape(-1, 3, 1).transpose(0, 2, 1)  # [N,1,3]
        n_rest = sum(1 for name in name_set if name.startswith("f_rest_"))
        if n_rest:
            rest = np.stack(
                [data[f"f_rest_{i}"] for i in range(n_rest)], axis=1
            ).astype(np.float32)
            k1 = n_rest // 3
            pc.shN = rest.reshape(-1, 3, k1).transpose(0, 2, 1)  # [N,K-1,3]
        else:
            pc.shN = np.zeros((n, 0, 3), np.float32)
        pc.opacity = data["opacity"].astype(np.float32).reshape(-1, 1)
        pc.scaling = np.stack([data[f"scale_{i}"] for i in range(3)], axis=1).astype(np.float32)
        pc.rotation = np.stack([data[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float32)
    elif {"red", "green", "blue"} <= name_set:
        pc.colors = np.stack(
            [data["red"], data["green"], data["blue"]], axis=1
        ).astype(np.float32)
        if props[[name for name, _ in props].index("red")][1] in ("float", "float32"):
            pc.colors *= 255.0
    if {"nx", "ny", "nz"} <= name_set:
        pc.normals = np.stack([data["nx"], data["ny"], data["nz"]], axis=1).astype(np.float32)
    return pc


def is_splat_ply(path: str | Path) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(4096).decode("ascii", errors="ignore")
        return head.startswith("ply") and "f_dc_0" in head
    except OSError:
        return False
