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
parameter names (JAX flattens dicts in sorted-key order).  Which optional
leaves exist (a ``head``, qkv biases) it reads from the dict keys that the
pickle's opcodes list (``pickletools.genops`` parses them without running
anything).  The packed entries of either writer load bit for bit.

Entry locations are the reference's: ``["prefix", i]`` for the first
``first_dense_layers`` layers (unstacked in the reference's tree, a list of
per-layer blocks), ``["groups", g, o]`` for block ``o`` of layer group
``g`` after them (``models.lm.layer_loc``; a group holds P blocks, each
position stacked over the groups in the reference's tree as ``b{o}``); the
port's flat layer index of a location is the number of prefix layers plus
g·P + o, with P one past the largest ``o`` of the entries (every block
has quantized weights).  An encoder-decoder's encoder blocks are at
``["enc", i]`` (the reference's stacked ``encoder.groups.b0``, one block a
group), the port's ``encoder/layers/<i>``; its residual holds the
encoder's norms and final norm and, when rotated, ``frame_proj``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickletools
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
            arr = np.require(arr, requirements="C")  # 0-d stays 0-d
            if arr.dtype.hasobject:
                raise ValueError(f"{name}: object arrays are not stored")
            header = io.BytesIO()
            npformat.write_array_header_1_0(
                header, npformat.header_data_from_array_1_0(arr))
            zi = zipfile.ZipInfo(name + ".npy",
                                 date_time=(1980, 1, 1, 0, 0, 0))
            zi.compress_type = zipfile.ZIP_STORED
            zi.external_attr = 0o600 << 16
            # the member's size up front, as ``writestr`` sets it (it
            # decides zip64): the same bytes, with the array written
            # straight from its buffer, not through an in-memory copy of
            # the whole .npy (a 256000 x 8192 fp32 table is 8.4 GB)
            zi.file_size = len(header.getvalue()) + arr.nbytes
            with zf.open(zi, "w") as dest:
                dest.write(header.getvalue())
                dest.write(memoryview(arr.reshape(-1)).cast("B"))
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
    """numpy has no bf16: a bf16 tensor (the residual of a model quantized
    in bf16) is stored widened to fp32, which is exact; the loaders'
    ``dtype`` casts it back."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save_field(arrays: dict, key: str, x: np.ndarray) -> dict:
    """One whole shard per field (the port runs on one device)."""
    arrays[f"{key}@0"] = x
    return {"shape": [int(s) for s in x.shape], "dtype": str(x.dtype),
            "shards": [[[0, int(s)] for s in x.shape]]}


def _assemble_field(z, key: str, fm: dict) -> np.ndarray:
    shape, dtype = tuple(fm["shape"]), np.dtype(fm["dtype"])
    if fm["shards"] == [[[0, n] for n in shape]]:  # one whole shard: as read
        a = z[f"{key}@0"]
        if a.shape == shape and a.dtype == dtype:
            return a
    out = np.empty(shape, dtype)
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


def _n_prefix(meta_entries: dict) -> int:
    """Prefix layers of an artifact: one past its last prefix location."""
    return 1 + max((em["loc"][1] for em in meta_entries.values()
                    if em["loc"][0] == "prefix"), default=-1)


def _period(meta_entries: dict) -> int:
    """Blocks a layer group of an artifact: one past its largest block
    position ``o`` (1 without group entries)."""
    return 1 + max((em["loc"][2] for em in meta_entries.values()
                    if em["loc"][0] == "groups"), default=0)


def _layer_index(loc: list, n_prefix: int, period: int) -> int:
    """The port's flat layer index of a reference location."""
    if loc[0] == "prefix":
        return int(loc[1])
    if loc[0] != "groups":
        raise NotImplementedError(
            f"entry at {loc}: the port reads decoder layers only")
    return n_prefix + int(loc[1]) * period + int(loc[2])


def _entry_paths(meta_entries: dict) -> dict[str, str]:
    """{entry name: port parameter path ("layers/<i>/<sub>/<name>", an
    encoder block's "encoder/layers/<i>/<sub>/<name>")}."""
    n_prefix, period = _n_prefix(meta_entries), _period(meta_entries)
    return {name: (f"encoder/layers/{em['loc'][1]}" if em["loc"][0] == "enc"
                   else f"layers/{_layer_index(em['loc'], n_prefix, period)}"
                   ) + f"/{em['path']}"
            for name, em in meta_entries.items()}


# fp leaves a block keeps in the residual, by a quantized weight that marks
# the block's kind (MLA's internal norms sit beside wq_b and wkv_b; a
# routed-expert FFN's fp32 router beside its expert stacks)
_BLOCK_RESIDUAL = {"mixer/wq_b": "mixer/q_norm",
                   "mixer/wkv_b": "mixer/kv_norm",
                   "ffn/experts/wi": "ffn/router"}
# a Mamba block's mixer leaves (models.ssm.init_mamba; wdt is fp where it
# is too narrow to quantize) and GQA's optional qkv biases
_MAMBA_LEAVES = ("wzx", "wbc", "wdt", "conv_x", "conv_bc", "conv_b", "A_log",
                 "D", "dt_bias", "norm", "out_proj")
_QKV_BIAS = ("bq", "bk", "bv")
# leaves a model holds in fp32 whatever its dtype (the MoE router, Mamba's
# A_log, D and dt_bias): the loaders' ``dtype`` leaves them fp32, as the
# reference's serve does
FP32_LEAVES = ("router", "A_log", "D", "dt_bias")


def _block_paths(quantized: set[str], keys: set[str]) -> list[str]:
    """Every leaf path of a block whose quantized weights are
    ``quantized``, in a tree whose dicts have the keys ``keys``: the
    leaves of its own mixer (a Mamba block's, or attention's with its
    internal norms and qkv biases), of an enc-dec decoder block's
    cross-attention sub-layer (``cross_norm``) and of its own FFN, if it
    has one (an FFN norm, and the router of routed experts; mamba2's
    blocks have none)."""
    paths = quantized | {"mixer_norm"} | {
        leaf for w, leaf in _BLOCK_RESIDUAL.items() if w in quantized}
    if any(p.startswith("cross/") for p in quantized):
        paths.add("cross_norm")
    if {"mixer/wzx", "mixer/out_proj"} & quantized:
        paths |= {f"mixer/{n}" for n in _MAMBA_LEAVES}
    elif "mixer/wq" in quantized and set(_QKV_BIAS) <= keys:
        paths |= {f"mixer/{n}" for n in _QKV_BIAS}
    if any(p.startswith("ffn/") for p in quantized):
        paths.add("ffn_norm")
    return sorted(paths)


def _treedef_keys(meta: dict) -> set[str]:
    """The strings of a reference artifact's pickled treedef (its dict
    keys among them), read by ``pickletools.genops``, which parses the
    opcodes and runs nothing; without a treedef, the keys of an untied
    decoder."""
    hexed = meta.get("residual_treedef")
    if hexed is None:
        return {"head"}
    return {arg for _, arg, _ in pickletools.genops(bytes.fromhex(hexed))
            if isinstance(arg, str)}


def _reference_residual_paths(n_prefix: int, prefix_paths: list[str],
                              group_paths: list[list[str]],
                              head: bool = True,
                              encoder_paths: list[str] | None = None,
                              frame_proj: bool = False) -> list[str]:
    """Leaf order of a reference-written residual tree: the reference's
    {"embed", "final_norm", "groups": {"b0": block, ..., "b{P-1}": block},
    "head", "prefix": [block, ...]} with stacked group leaves and
    ``n_prefix`` unstacked prefix blocks, flattened in sorted-key order
    (JAX's: "b10" before "b2").  The prefix blocks and each block position
    ``o`` of a group (``group_paths[o]``) have their own leaves (deepseek's
    dense prefix and its routed-expert groups; jamba's Mamba and GQA
    blocks, dense and routed-expert FFNs); a tied model has no ``head``.
    An encoder-decoder adds {"encoder": {"final_norm", "groups": {"b0":
    block}}} (``encoder_paths``, its blocks stacked) and, rotated,
    ``frame_proj``."""
    def block(paths) -> dict:
        node_root: dict = {}
        for p in paths:
            node = node_root
            parts = p.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = 0
        return node_root

    skel: dict = {"embed": 0, "final_norm": 0,
                  "groups": {f"b{o}": block(paths)
                             for o, paths in enumerate(group_paths)}}
    if head:
        skel["head"] = 0
    if encoder_paths is not None:
        skel["encoder"] = {"final_norm": 0,
                           "groups": {"b0": block(encoder_paths)}}
    if frame_proj:
        skel["frame_proj"] = 0
    if n_prefix:
        skel["prefix"] = [block(prefix_paths) for _ in range(n_prefix)]
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
    skip = set(_entry_paths(meta_entries).values())
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


def load_packed_entry(directory, name: str, *, verify: bool = False
                      ) -> dict:
    """One entry's numpy ``codes``, ``scale`` and ``zero`` as stored: the
    npz members load lazily, so this reads just that entry's shards (the
    reference's ``load_packed_entry``); ``verify`` hashes the whole
    packed.npz first."""
    d = Path(directory)
    meta = json.loads((d / "meta.json").read_text())
    if verify:
        _verify_file(d, meta, "packed.npz")
    em = meta["entries"][name]
    with np.load(d / "packed.npz") as z:
        return {f: _assemble_field(z, f"{name}/{f}", fm)
                for f, fm in em["fields"].items()}


def _load_residual(d: Path, meta: dict, verify: bool) -> dict[str, np.ndarray]:
    """{port parameter path: array} of the residual leaves."""
    if verify:
        _verify_file(d, meta, "residual.npz")
    with np.load(d / "residual.npz") as z:
        leaves = [_assemble_field(z, f"leaf_{i}", fm)
                  for i, fm in enumerate(meta["residual_leaves"])]
    if "residual_paths" in meta:  # written by the port
        return dict(zip(meta["residual_paths"], leaves))
    # written by the reference: prefix blocks as they are, each block
    # position's stacked group leaves, in sorted-key order; quantized
    # leaves are empty markers
    n_prefix, period = _n_prefix(meta["entries"]), _period(meta["entries"])
    prefix: set = set()
    enc: set = set()
    group: list[set] = [set() for _ in range(period)]
    for em in meta["entries"].values():
        loc = em["loc"]
        (prefix if loc[0] == "prefix" else enc if loc[0] == "enc"
         else group[loc[2]]).add(em["path"])
    keys = _treedef_keys(meta)
    paths = _reference_residual_paths(
        n_prefix, _block_paths(prefix, keys),
        [_block_paths(q, keys) for q in group], head="head" in keys,
        encoder_paths=_block_paths(enc, keys) if enc else None,
        frame_proj="frame_proj" in keys)
    if len(paths) != len(leaves):
        raise NotImplementedError(
            f"{d}: {len(leaves)} residual leaves, expected {len(paths)} for "
            f"a decoder of {n_prefix} prefix blocks and layer groups of "
            f"{period} blocks ({paths})")
    out = {}
    for path, leaf in zip(paths, leaves):
        if path.startswith("prefix/"):
            _, li, rest = path.split("/", 2)
            if leaf.size:
                out[f"layers/{li}/{rest}"] = leaf
        elif path.startswith("encoder/groups/"):
            if leaf.size:  # the encoder's (n_enc, ...) stacked leaf
                rest = path.split("/", 3)[3]
                for li in range(leaf.shape[0]):
                    out[f"encoder/layers/{li}/{rest}"] = leaf[li]
        elif not path.startswith("groups/"):
            out[path] = leaf
        elif leaf.size:  # block o's (n_groups, ...) stacked leaf: unstack
            _, b, rest = path.split("/", 2)
            for g in range(leaf.shape[0]):
                out[f"layers/{n_prefix + g * period + int(b[1:])}/{rest}"] = \
                    leaf[g]
    return out


def _build_tree(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    for node in (tree, tree.get("encoder")):
        if node is not None:  # the decoder's and the encoder's layers
            layers = node.pop("layers", {})
            node["layers"] = [layers[str(i)] for i in range(len(layers))]
    return tree


def _load(directory, device, dtype, verify: bool, keep_packed: bool):
    device = resolve_device(device)
    d = Path(directory)
    entries, meta = load_packed_artifact(d, verify=verify)
    flat: dict[str, Any] = {}
    for path, a in _load_residual(d, meta, verify).items():
        # the arrays np.load returns are fresh and writable: no copy here
        # (a 256000 x 8192 fp32 table is 8.4 GB)
        t = torch.from_numpy(np.require(a, requirements=["C", "W"])
                             ).to(device)
        keep = dtype is None or path.rsplit("/", 1)[-1] in FP32_LEAVES
        flat[path] = t if keep else t.to(dtype)
    spec = meta["spec"]
    paths = _entry_paths(meta["entries"])
    for name, em in meta["entries"].items():
        path = paths[name]
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
    (embedding, head, norms, biases) but ``FP32_LEAVES``; scales and zeros
    stay fp32."""
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
