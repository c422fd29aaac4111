"""Wavefront OBJ load and save with MTL support.

Counterpart of `diffsound_tpu/render/obj.py`: host-side parsing into a
render `Mesh` (positions, texcoords and normals with their own index
buffers, the material dict), polygons fan-triangulated, texcoords' v
flipped; normals derived when the file has none, tangents when it has
texcoords."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .material import default_material, load_mtl, save_mtl
from .mesh import Mesh, auto_normals, compute_tangents


def load_obj(fn: str, clear_ks: bool = True, mtl_override=None, device="cuda") -> Mesh:
    """The mesh of an .obj file, float32 and int64 tensors on `device`."""
    dev = resolve_device(device)
    base = os.path.dirname(fn)
    verts, texcoords, normals = [], [], []
    faces, tfaces, nfaces = [], [], []
    all_materials = []
    with open(fn) as f:
        lines = f.readlines()
    for line in lines:
        split = line.split()
        if not split:
            continue
        prefix = split[0]
        if prefix == "mtllib" and mtl_override is None:
            mtl_path = os.path.join(base, split[1])
            if os.path.exists(mtl_path):
                all_materials += load_mtl(mtl_path, clear_ks)
        elif prefix == "v":
            verts.append([float(x) for x in split[1:4]])
        elif prefix == "vt":
            u, v = (float(x) for x in split[1:3])
            texcoords.append([u, 1.0 - v])
        elif prefix == "vn":
            normals.append([float(x) for x in split[1:4]])
        elif prefix == "f":
            def parse(tok):
                parts = tok.split("/")
                vi = int(parts[0]) - 1
                ti = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
                ni = int(parts[2]) - 1 if len(parts) > 2 and parts[2] else -1
                return vi, ti, ni

            corners = [parse(t) for t in split[1:]]
            for i in range(len(corners) - 2):  # fan triangulation
                tri = (corners[0], corners[i + 1], corners[i + 2])
                faces.append([c[0] for c in tri])
                tfaces.append([c[1] for c in tri])
                nfaces.append([c[2] for c in tri])

    material = mtl_override if mtl_override is not None else (
        all_materials[0] if all_materials else default_material())
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    m = Mesh(v_pos=f32(verts), t_pos_idx=i64(faces), material=material)
    if texcoords:
        m = m.with_(v_tex=f32(texcoords), t_tex_idx=i64(tfaces))
    if normals:
        m = m.with_(v_nrm=f32(normals), t_nrm_idx=i64(nfaces))
    else:
        m = auto_normals(m)
    if m.v_tex is not None:
        m = compute_tangents(m)
    return m


def write_obj(folder: str, mesh: Mesh, name: str = "mesh.obj", save_material: bool = True,
              material_params=None) -> str:
    """Write `mesh` as <folder>/<name> (and mesh.mtl beside it); returns the
    .obj path."""
    os.makedirs(folder, exist_ok=True)
    obj_path = os.path.join(folder, name)
    host = lambda t: None if t is None else t.detach().cpu().numpy()
    v, vt, vn = host(mesh.v_pos), host(mesh.v_tex), host(mesh.v_nrm)
    fp = host(mesh.t_pos_idx) + 1
    ft = host(mesh.t_tex_idx) + 1 if mesh.t_tex_idx is not None else fp
    fnr = host(mesh.t_nrm_idx) + 1 if mesh.t_nrm_idx is not None else fp
    with open(obj_path, "w") as f:
        f.write("mtllib mesh.mtl\ng default\n")
        for p in v:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if vt is not None:
            for t in vt:
                f.write(f"vt {t[0]:.6f} {1.0 - t[1]:.6f}\n")
        if vn is not None:
            for n in vn:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        f.write("usemtl defaultMat\n")
        for i in range(fp.shape[0]):
            toks = [f"{fp[i, k]}/{ft[i, k] if vt is not None else ''}/"
                    f"{fnr[i, k] if vn is not None else ''}" for k in range(3)]
            f.write("f " + " ".join(toks) + "\n")
    if save_material and mesh.material is not None:
        save_mtl(os.path.join(folder, "mesh.mtl"), mesh.material, material_params)
    return obj_path
