"""Material dicts and MTL IO.

Counterpart of `diffsound_tpu/render/material.py`.  A material is a plain
dict {"name", "bsdf", "kd": Texture2D, "ks": Texture2D, optionally
"normal": Texture2D or "kd_ks_normal": MLPTexture3D}; the textures' payloads
live in a parallel params dict (`material_params`), so an optimizer sees
plain tensors."""

from __future__ import annotations

import os

import numpy as np

from .texture import Texture2D, srgb_texture


def default_material(bsdf: str = "pbr", kd=(0.8, 0.8, 0.8), ks=(0.0, 0.5, 0.0)):
    return {
        "name": "_default_mat",
        "bsdf": bsdf,
        "kd": Texture2D(np.asarray(kd, np.float32), min_max=[[0, 0, 0], [1, 1, 1]]),
        "ks": Texture2D(np.asarray(ks, np.float32), min_max=[[0, 0.08, 0], [0, 1, 1]]),
    }


def material_params(mat: dict) -> dict:
    """The trainable payloads of a material dict's textures."""
    return {k: v.params for k, v in mat.items() if isinstance(v, Texture2D)}


def _load_img(path):
    from .util import load_image

    return load_image(path)


def load_mtl(fn: str, clear_ks: bool = True):
    """Parse a .mtl file -> a list of material dicts (texture maps read with
    `util.load_image`, map_Kd from sRGB to linear)."""
    base = os.path.dirname(fn)
    materials = []
    mat = None
    with open(fn) as f:
        for line in f:
            split = line.split()
            if not split:
                continue
            prefix = split[0].lower()
            if prefix == "newmtl":
                mat = {"name": split[1], "bsdf": "pbr"}
                materials.append(mat)
            elif mat is None:
                continue
            elif prefix == "map_kd":
                mat["kd"] = Texture2D(srgb_texture(_load_img(os.path.join(base, split[1]))))
            elif prefix == "map_ks":
                mat["ks"] = Texture2D(_load_img(os.path.join(base, split[1])))
            elif prefix == "bump":
                mat["normal"] = Texture2D(_load_img(os.path.join(base, split[1])) * 2.0 - 1.0)
            elif prefix in ("kd", "ks"):
                mat[prefix] = Texture2D(np.asarray([float(x) for x in split[1:4]], np.float32))
            elif prefix == "bsdf":
                mat["bsdf"] = split[1]
    for m in materials:
        if "kd" not in m:
            m["kd"] = Texture2D(np.asarray([0.8, 0.8, 0.8], np.float32))
        if "ks" not in m or clear_ks:
            m["ks"] = Texture2D(np.asarray([0.0, 0.5, 0.0], np.float32))
    return materials


def save_mtl(fn: str, material: dict, params: dict = None):
    """Write a minimal .mtl; image-shaped texture payloads go to PNGs beside
    it (kd through the sRGB transfer)."""
    import torch

    from .util import rgb_to_srgb, save_image

    base = os.path.dirname(fn)
    with open(fn, "w") as f:
        f.write(f"newmtl {material.get('name', 'defaultMat')}\n")
        f.write(f"bsdf {material.get('bsdf', 'pbr')}\n")
        for key, mtl_name, srgb in (("kd", "Kd", True), ("ks", "Ks", False)):
            tex = material.get(key)
            if tex is None:
                continue
            p = params.get(key) if params else tex.params
            p = p[0] if isinstance(p, (list, tuple)) else p
            arr = torch.as_tensor(p).detach().cpu().float()
            if arr.dim() == 3 and arr.shape[0] > 1:
                img = rgb_to_srgb(torch.clamp(arr, 0.0, 1.0)) if srgb else arr
                save_image(os.path.join(base, f"texture_{key}.png"), img.numpy())
                f.write(f"map_{mtl_name} texture_{key}.png\n")
            else:
                vals = arr.reshape(-1)[:3].tolist()
                f.write(f"{mtl_name} {vals[0]:.6f} {vals[1]:.6f} {vals[2]:.6f}\n")


def merge_materials(materials, texcoords, tfaces, mfaces):
    """One material for a mesh of several: material 0's, the texcoords
    unchanged (as the JAX package does; no atlas merging)."""
    assert len(materials) > 0
    return materials[0], texcoords, tfaces
