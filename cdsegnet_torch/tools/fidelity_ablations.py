"""Quantify the documented fidelity deviations on synthetic data.

Port of `tools/fidelity_ablations.py` over the port's own geometry
(`models/structure.py`), which copies the JAX package's redesigns. Three
deviations from the reference are bounded numerically, so that each cost
is a measured quantity instead of a guess:

1. **k5 stem = 2-hop k3 closure** (`models/structure.compose_k5_table`):
   fraction of true 5x5x5 submanifold neighbors missed because every
   intermediate 3x3x3 voxel on the path is empty, and the same for the
   shipped exact shell lookup (`build_k5_shell_table`, expected 0).
   Reference builds the exact table via spconv hashing
   (`point_transformer_v3m1_base.py:646`).
2. **Nearest vs trilinear devoxelization** (`models/spvcnn.py`): relative
   L2 error of reconstructing a smooth per-point field from voxel means by
   containing-voxel broadcast (ours) vs trilinear interpolation
   (torchsparse `voxel_to_point`, `ts_spvcnn.py:79-123`).
3. **OA-CNNs power-of-two cluster scales** (`models/oacnns.py`): relative
   change in mean cluster population when reference metric scales are
   rounded to powers of two.

Run: python -m cdsegnet_torch.tools.fidelity_ablations [--device cpu]
(the neighbor tables on the card unless ``--device`` names another device;
the rest is host numpy). `main(argv)` takes the arguments as a list.
"""

import argparse

import numpy as np
import torch

from cdsegnet_torch.models.structure import (build_k5_shell_table, build_neighbor_table,
                                             compose_k5_table)
from cdsegnet_torch.utils.device import resolve_device


def surface_scene(rng, n=20000, grid=0.02, kind="surface"):
    """ScanNet-like voxelized point set: smooth height-field surface plus
    walls, or uniform random occupancy (worst case)."""
    if kind == "surface":
        xy = rng.rand(n, 2) * 4.0
        z = (
            0.4 * np.sin(xy[:, 0] * 2.0)
            + 0.3 * np.cos(xy[:, 1] * 2.5)
            + 0.05 * rng.randn(n)
            + 1.0
        )
        pts = np.column_stack([xy, z])
        # add two walls
        w = rng.rand(n // 4, 2) * np.array([4.0, 2.0])
        pts = np.concatenate([
            pts,
            np.column_stack([w[:, 0], np.zeros(len(w)), w[:, 1]]),
            np.column_stack([np.zeros(len(w)), w[:, 0], w[:, 1]]),
        ])
    else:
        pts = rng.rand(n, 3) * 1.2  # dense-ish random occupancy
    gc = np.unique(np.floor(pts / grid).astype(np.int64), axis=0)
    return gc


def k5_closure_miss_rate(kind="surface", seed=0, device=None):
    """Miss rates of both k5 builders vs hash-table ground truth: the
    retired 2-hop closure (`compose_k5_table`) and the shipped exact
    shell lookup (`build_k5_shell_table`, expected 0); the tables are built
    on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    gc = surface_scene(rng, kind=kind)
    n = len(gc)
    depth = int(np.ceil(np.log2(gc.max() + 3)))
    gct = torch.as_tensor(gc.astype(np.int32), device=dev)
    batch = torch.zeros((n,), dtype=torch.int32, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    n3 = build_neighbor_table(gct, batch, mask, depth=depth, kernel_size=3)
    n5_closure = compose_k5_table(n3).cpu().numpy()
    n5_exact = build_k5_shell_table(gct, batch, mask, n3, depth=depth).cpu().numpy()

    # exact k5 ground truth by hashing
    occ = {tuple(v): i for i, v in enumerate(gc)}
    offs5 = [
        (x, y, z)
        for x in range(-2, 3) for y in range(-2, 3) for z in range(-2, 3)
    ]
    total = 0
    missed = np.zeros(2, np.int64)
    sample = rng.choice(n, size=min(n, 4000), replace=False)
    for i in sample:
        base = gc[i]
        for j, d in enumerate(offs5):
            t = (base[0] + d[0], base[1] + d[1], base[2] + d[2])
            if t in occ:
                total += 1
                missed[0] += n5_closure[i, j] != occ[t]
                missed[1] += n5_exact[i, j] != occ[t]
    return missed[0] / max(total, 1), missed[1] / max(total, 1), total


def devox_error(seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.rand(50000, 3) * 4.0
    field = (
        np.sin(pts[:, 0] * 1.7)
        + np.cos(pts[:, 1] * 2.3) * 0.7
        + pts[:, 2] * 0.5
    )
    grid = 0.08  # 4x the 0.02 base, like one pooled level
    vox = np.floor(pts / grid).astype(np.int64)
    key = (vox[:, 0] << 40) | (vox[:, 1] << 20) | vox[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    vsum = np.zeros(len(uniq))
    vcnt = np.zeros(len(uniq))
    np.add.at(vsum, inv, field)
    np.add.at(vcnt, inv, 1)
    vmean = vsum / vcnt
    csum = np.zeros((len(uniq), 3))
    np.add.at(csum, inv, pts)
    vcenter = csum / vcnt[:, None]

    nearest = vmean[inv]

    # trilinear over the 8 surrounding voxel sites (torchsparse semantics:
    # weights from the fractional position among voxel corners)
    lut = {k: i for i, k in enumerate(uniq)}
    rel = pts / grid - 0.5
    base = np.floor(rel).astype(np.int64)
    frac = rel - base
    tri = np.zeros(len(pts))
    wsum = np.zeros(len(pts))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                v = base + np.array([dx, dy, dz])
                k = (v[:, 0] << 40) | (v[:, 1] << 20) | v[:, 2]
                idx = np.array([lut.get(int(x), -1) for x in k])
                w = (
                    np.where(dx, frac[:, 0], 1 - frac[:, 0])
                    * np.where(dy, frac[:, 1], 1 - frac[:, 1])
                    * np.where(dz, frac[:, 2], 1 - frac[:, 2])
                )
                hit = idx >= 0
                tri[hit] += w[hit] * vmean[idx[hit]]
                wsum[hit] += w[hit]
    tri = np.where(wsum > 1e-6, tri / np.maximum(wsum, 1e-6), nearest)

    scale = np.linalg.norm(field - field.mean())
    return (
        np.linalg.norm(nearest - field) / scale,
        np.linalg.norm(tri - field) / scale,
    )


def oacnns_scale_shift(seed=0):
    rng = np.random.RandomState(seed)
    gc = surface_scene(rng, kind="surface")
    # reference stage-0 scales on the 0.02 grid vs our pow2 rounding
    # (oacnns_v1m1_base.py point_grid_size; ours models/oacnns.py:10-14)
    out = []
    for ref_s, ours_s in ((12, 16), (24, 32), (48, 64)):
        def pop(s):
            v = gc // s
            k = (v[:, 0] << 40) | (v[:, 1] << 20) | v[:, 2]
            _, cnt = np.unique(k, return_counts=True)
            return cnt.mean()

        out.append((ref_s, ours_s, pop(ref_s), pop(ours_s)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of the neighbor tables (default: the GPU)")
    args = ap.parse_args(argv)
    for kind in ("surface", "random"):
        m_closure, m_exact, total = k5_closure_miss_rate(kind, device=args.device)
        print(f"k5 miss rate ({kind}, {total} true pairs): 2-hop closure "
              f"{m_closure:.4%}, exact shell lookup {m_exact:.4%}")
    ne, te = devox_error()
    print(f"devoxelization rel-L2: nearest {ne:.4f} vs trilinear {te:.4f} "
          f"(smooth field, 0.08 m voxels)")
    for ref_s, ours_s, pr, po in oacnns_scale_shift():
        print(f"OA-CNNs cluster scale {ref_s}->{ours_s} voxels: mean cluster "
              f"population {pr:.1f} -> {po:.1f} ({po / pr:.2f}x)")


if __name__ == "__main__":
    main()
