"""Packed serving artifact (format v3): the calibration -> serving hand-off.

Layout of ``<dir>/``, shared with the reference:

  meta.json     format tag, quant spec, per-file SHA-256 checksums, and per
                entry: path, layer tag, location, d_in, group_size, dtype
                and the shard index of each saved field
  packed.npz    ``"<entry>/<field>@<k>"`` -> the k-th shard of the entry's
                ``codes`` (uint32 words), ``scale`` or ``zero``
  residual.npz  the unquantized rest of the param tree (embedding, head,
                norms) as ``"leaf_<i>@<k>"``

Every file is written to a temp path and renamed into place, with fixed zip
timestamps, so identical arrays give byte-identical files; ``meta.json`` is
written last.  Loaders check each file's SHA-256 before reading it.

The reference names its residual leaves by a pickled JAX treedef, which the
port cannot read without JAX.  The port never unpickles: it writes the
parameter path of each residual leaf (``residual_paths``) and, reading a
reference-written artifact, rebuilds the reference's leaf order from the
parameter names (JAX flattens dicts in sorted-key order).  The packed
entries of either writer load bit for bit.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.quantizer import dequantize_packed, words_to_numpy
from repro_torch.device import resolve_device
from repro_torch.kernels.quant_matmul.ops import (PackedWeight,
                                                  packed_weight_from_artifact)

FORMAT = "rsq-packed-v3"
_FIELDS = ("codes", "scale", "zero")


class ArtifactCorruptError(RuntimeError):
    """A packed artifact file failed its recorded SHA-256 check."""


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _savez_atomic(path: Path, arrays: dict) -> str:
    """Write ``arrays`` as a canonical npz (stored members, fixed
    timestamps) through a temp file + ``os.replace``; returns its sha256."""
    from numpy.lib import format as npformat

    tmp = path.with_suffix(path.suffix + ".tmp")
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            npformat.write_array(buf, np.asarray(arr), allow_pickle=False)
            zi = zipfile.ZipInfo(name + ".npy",
                                 date_time=(1980, 1, 1, 0, 0, 0))
            zi.compress_type = zipfile.ZIP_STORED
            zi.external_attr = 0o600 << 16
            zf.writestr(zi, buf.getvalue())
    sha = _sha256_file(tmp)
    os.replace(tmp, path)
    return sha


def _verify_file(d: Path, meta: dict, fname: str) -> None:
    want = (meta.get("checksums") or {}).get(fname)
    if meta.get("format") != FORMAT or want is None:
        raise ArtifactCorruptError(
            f"{d}: not a {FORMAT} artifact with a checksum for {fname}")
    got = _sha256_file(d / fname)
    if got != want:
        raise ArtifactCorruptError(
            f"{d / fname} is corrupt: sha256 {got[:16]}… does not match the "
            f"recorded {want[:16]}…; regenerate it with launch.quantize "
            f"--pack-out {d}")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("the artifact stores float32 tensors, not bf16")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save_field(arrays: dict, key: str, x: np.ndarray) -> dict:
    """One whole shard per field (the port runs on one device)."""
    arrays[f"{key}@0"] = x
    return {"shape": [int(s) for s in x.shape], "dtype": str(x.dtype),
            "shards": [[[0, int(s)] for s in x.shape]]}


def _assemble_field(z, key: str, fm: dict) -> np.ndarray:
    out = np.empty(tuple(fm["shape"]), np.dtype(fm["dtype"]))
    for k, idx in enumerate(fm["shards"]):
        out[tuple(slice(lo, hi) for lo, hi in idx)] = z[f"{key}@{k}"]
    return out


# --------------------------------------------------------------- tree paths


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{"a/b/c": leaf} in sorted-key order (JAX's dict flattening order);
    list items are keyed by their index."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _quantized_paths(meta_entries: dict) -> set[str]:
    """Port parameter paths ("layers/<i>/<sub>/<name>") of packed entries."""
    out = set()
    for em in meta_entries.values():
        if em["loc"][0] != "groups" or em["loc"][2] != 0:
            raise NotImplementedError(
                f"entry at {em['loc']}: the port reads dense decoders with "
                f"one block per layer group")
        out.add(f"layers/{em['loc'][1]}/{em['path']}")
    return out


def _reference_residual_paths(n_layers: int, block_paths: list[str]
                              ) -> list[str]:
    """Leaf order of a reference-written residual tree: the reference's
    {"embed", "final_norm", "groups": {"b0": block}, "head"} with stacked
    group leaves, flattened in sorted-key order."""
    skel: dict = {"embed": 0, "final_norm": 0, "head": 0, "groups": {"b0": {}}}
    for p in block_paths:
        node = skel["groups"]["b0"]
        parts = p.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = 0
    return list(_flatten(skel))


# -------------------------------------------------------------------- save


def save_packed_artifact(directory, artifact: dict, *, params: dict,
                         extra: dict | None = None) -> Path:
    """Persist a pipeline artifact (``RSQPipeline.artifact``) and the fp
    residual of ``params`` (its quantized leaves are left out)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta_entries: dict[str, dict] = {}
    for name, entry in artifact["entries"].items():
        em = dict(artifact["meta"][name])
        fields = {}
        for field in _FIELDS:
            x = entry[field]
            x = (words_to_numpy(x) if field == "codes" and
                 isinstance(x, torch.Tensor) else _to_numpy(x))
            fields[field] = _save_field(arrays, f"{name}/{field}", x)
        em["fields"] = fields
        meta_entries[name] = em
    meta = {"format": FORMAT, "spec": artifact["spec"],
            "entries": meta_entries, "extra": extra or {}, "checksums": {}}
    skip = _quantized_paths(meta_entries)
    res_arrays: dict[str, np.ndarray] = {}
    paths, leaves_meta = [], []
    for path, leaf in _flatten(params).items():
        if path in skip:
            continue
        paths.append(path)
        leaves_meta.append(_save_field(res_arrays, f"leaf_{len(paths) - 1}",
                                       _to_numpy(leaf)))
    meta["residual_paths"] = paths
    meta["residual_leaves"] = leaves_meta
    meta["checksums"]["residual.npz"] = _savez_atomic(d / "residual.npz",
                                                      res_arrays)
    meta["checksums"]["packed.npz"] = _savez_atomic(d / "packed.npz", arrays)
    tmp = d / "meta.tmp.json"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, d / "meta.json")
    return d


# -------------------------------------------------------------------- load


def load_packed_artifact(directory, *, verify: bool = True
                         ) -> tuple[dict, dict]:
    """-> (entries, meta): per entry the numpy ``codes`` (uint32),
    ``scale`` and ``zero`` exactly as stored."""
    d = Path(directory)
    meta = json.loads((d / "meta.json").read_text())
    if meta.get("format") != FORMAT:
        raise ArtifactCorruptError(
            f"{d}: format {meta.get('format')!r}, expected {FORMAT}")
    if verify:
        _verify_file(d, meta, "packed.npz")
    with np.load(d / "packed.npz") as z:
        entries = {name: {f: _assemble_field(z, f"{name}/{f}", fm)
                          for f, fm in em["fields"].items()}
                   for name, em in meta["entries"].items()}
    return entries, meta


def _load_residual(d: Path, meta: dict, verify: bool) -> dict[str, np.ndarray]:
    """{port parameter path: array} of the residual leaves."""
    if verify:
        _verify_file(d, meta, "residual.npz")
    with np.load(d / "residual.npz") as z:
        leaves = [_assemble_field(z, f"leaf_{i}", fm)
                  for i, fm in enumerate(meta["residual_leaves"])]
    if "residual_paths" in meta:  # written by the port
        return dict(zip(meta["residual_paths"], leaves))
    # written by the reference: stacked group leaves in sorted-key order;
    # quantized leaves are empty markers
    block = sorted({em["path"] for em in meta["entries"].values()}
                   | {"mixer_norm", "ffn_norm"})
    n_layers = 1 + max(em["loc"][1] for em in meta["entries"].values())
    paths = _reference_residual_paths(n_layers, block)
    if len(paths) != len(leaves):
        raise NotImplementedError(
            f"{d}: {len(leaves)} residual leaves, expected {len(paths)} for "
            f"a dense decoder ({paths})")
    out = {}
    for path, leaf in zip(paths, leaves):
        if not path.startswith("groups/b0/"):
            out[path] = leaf
        elif leaf.size:  # stacked (n_layers, ...) leaf: unstack
            for li in range(leaf.shape[0]):
                out[f"layers/{li}/{path[len('groups/b0/'):]}"] = leaf[li]
    return out


def _build_tree(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    layers = tree.pop("layers", {})
    tree["layers"] = [layers[str(i)] for i in range(len(layers))]
    return tree


def _load(directory, device, dtype, verify: bool, keep_packed: bool):
    device = resolve_device(device)
    d = Path(directory)
    entries, meta = load_packed_artifact(d, verify=verify)
    flat: dict[str, Any] = {}
    for path, a in _load_residual(d, meta, verify).items():
        t = torch.from_numpy(np.array(a)).to(device)
        flat[path] = t.to(dtype) if dtype is not None else t
    spec = meta["spec"]
    for name, em in meta["entries"].items():
        path = f"layers/{em['loc'][1]}/{em['path']}"
        pw = packed_weight_from_artifact(entries[name], em, spec, device)
        if keep_packed:
            flat[path] = pw
        else:
            w = dequantize_packed(pw.w_packed, pw.scale, pw.zero,
                                  bits=pw.bits, d_in=pw.d_in)
            flat[path] = w.to(getattr(torch, em.get("dtype", "float32")))
    return _build_tree(flat), meta


def load_packed_forward_params(directory, *, device="cuda", dtype=None,
                               verify: bool = True) -> tuple[dict, dict]:
    """-> (params, meta) with every quantized matrix a ``PackedWeight`` on
    ``device``: the codes stay packed on the device and every projection
    runs through ``quant_matmul``.  ``dtype`` casts the fp residual
    (embedding, head, norms); scales and zeros stay fp32."""
    return _load(directory, device, dtype, verify, keep_packed=True)


def load_packed_params(directory, *, device="cuda", dtype=None,
                       verify: bool = True) -> tuple[dict, dict]:
    """-> (params, meta) with every quantized matrix dequantized on
    ``device`` at load time, in the dtype it was quantized from (the
    comparison path for keep-packed serving); ``dtype`` casts only the
    residual."""
    return _load(directory, device, dtype, verify, keep_packed=False)


def resident_weight_bytes(params: dict) -> tuple[int, int]:
    """(packed bytes, fp bytes) resident in a param tree."""
    packed = fp = 0
    for leaf in _flatten(params).values():
        if isinstance(leaf, PackedWeight):
            packed += leaf.nbytes
        else:
            fp += leaf.numel() * leaf.element_size()
    return packed, fp
