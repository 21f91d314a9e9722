"""Serving export: freeze the trained forward pass into a self-contained,
reloadable artifact.

The reference's only deployment story is re-running the TF1 session predict
loop with a checkpoint (framework_operations.py:169-236), which needs the
full framework + model description at serving time. Here `export_serving`
compiles `GnnModel.apply` at a fixed batch shape through `jax.export` into a
serialized StableHLO program plus a params archive and a JSON manifest; at
serving time `load_serving` rehydrates it WITHOUT re-tracing the model
builder — the artifact is the executable.

Artifact directory layout:
  MANIFEST.json   format version, label/denormalization names, label domain,
                  input signature (name -> shape/dtype), platforms
  forward.bin     the exported program: serialized StableHLO (VHLO, a stable
                  format) of jax.export's lowering
  forward.json    what jax.export needs beside it to call the program
                  (avals, platforms, calling convention; _save_exported)
  params.npz      parameter leaves (p00000, p00001, ...)
  params_tree.json nested structure with leaf indices (dict/list/tuple)
  meta.json       the BatchMeta the shapes were specialized to

Notes:
- The exported program is specialized to the lowering platform(s). Fast
  paths chosen at trace time (Pallas kernels, dense incidence) follow the
  platform the export runs under: export on a GPU host (or pass
  platforms=("cuda",)) for the GPU program with its kernels.
- Denormalization runs OUTSIDE the artifact (host-side, by registry name),
  mirroring the reference's predict denorm (f_o.py:209-213).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .data.graph import BatchMeta, infer_label_domain

# 2: forward.bin holds the bare StableHLO module, forward.json its call
# signature (1 held jax.export's flatbuffers serialization)
FORMAT_VERSION = 2

# --------------------------------------------------------------------------
# pytree <-> (leaves, json structure)
# --------------------------------------------------------------------------


def _encode_tree(tree: Any, leaves: List[np.ndarray]) -> Any:
    """Replace array leaves with {"__leaf__": idx}; keep dict/list/tuple
    structure JSON-encodable (tuple tagged to round-trip exactly; None, an
    empty subtree to JAX, stays None)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _encode_tree(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [_encode_tree(v, leaves) for v in tree]}
    if isinstance(tree, list):
        return [_encode_tree(v, leaves) for v in tree]
    leaves.append(np.asarray(tree))
    return {"__leaf__": len(leaves) - 1}


def _decode_tree(node: Any, leaves: Sequence[np.ndarray]) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        if "__leaf__" in node:
            return leaves[node["__leaf__"]]
        if "__tuple__" in node:
            return tuple(_decode_tree(v, leaves) for v in node["__tuple__"])
        return {k: _decode_tree(v, leaves) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_tree(v, leaves) for v in node]
    raise ValueError(f"corrupt params_tree node: {node!r}")


def _meta_to_json(meta: BatchMeta) -> Dict[str, Any]:
    return {
        "num_graphs": meta.num_graphs,
        "node_pad": list(map(list, meta.node_pad)),
        "edge_pad": list(map(list, meta.edge_pad)),
        "max_len": list(map(list, meta.max_len)),
        "interleave_len": list(map(list, meta.interleave_len)),
        "label_pad": meta.label_pad,
        "bwd_len": list(map(list, meta.bwd_len)),
        "inc_blocks": [[k, list(v)] for k, v in meta.inc_blocks],
        "extra_layout": list(map(list, meta.extra_layout)),
        "extra_pad": list(map(list, meta.extra_pad)),
    }


def _meta_from_json(d: Mapping[str, Any]) -> BatchMeta:
    pairs = lambda rows: tuple((k, int(v)) for k, v in rows)
    return BatchMeta(
        num_graphs=int(d["num_graphs"]),
        node_pad=pairs(d["node_pad"]),
        edge_pad=pairs(d["edge_pad"]),
        max_len=pairs(d["max_len"]),
        interleave_len=pairs(d.get("interleave_len", ())),
        label_pad=int(d.get("label_pad", 0)),
        bwd_len=pairs(d.get("bwd_len", ())),
        inc_blocks=tuple(
            (k, tuple(int(x) for x in v)) for k, v in d.get("inc_blocks", ())
        ),
        extra_layout=tuple((k, str(v)) for k, v in d.get("extra_layout", ())),
        extra_pad=pairs(d.get("extra_pad", ())),
    )


_NON_INPUT_KEYS = ("label", "label_mask", "label_perm")


def _serving_arrays(arrays: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The forward pass never reads labels; drop them from the signature."""
    return {k: v for k, v in arrays.items() if k not in _NON_INPUT_KEYS}


# --------------------------------------------------------------------------
# the exported program on disk
# --------------------------------------------------------------------------
#
# jax.export's own `serialize` needs the flatbuffers package; this format
# needs nothing beyond JAX. It covers what export_serving produces: one
# device, no effects, static shapes, no VJP. Rebuilding the Exported fills
# in fields JAX keeps private; _load_exported is the one place that does.


def _save_exported(exported, out_dir: str) -> None:
    if exported.nr_devices != 1 or exported.ordered_effects or (
        exported.unordered_effects
    ):
        raise ValueError("serving artifacts hold single-device programs "
                         "without effects")
    with open(os.path.join(out_dir, "forward.bin"), "wb") as f:
        f.write(bytes(exported.mlir_module_serialized))
    meta = {
        "fun_name": exported.fun_name,
        "in_avals": [[list(a.shape), str(a.dtype)] for a in exported.in_avals],
        "out_avals": [[list(a.shape), str(a.dtype)]
                      for a in exported.out_avals],
        "platforms": list(exported.platforms),
        "disabled_custom_calls": [
            c.is_custom_call() for c in exported.disabled_safety_checks
            if c.is_custom_call()
        ],
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }
    with open(os.path.join(out_dir, "forward.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _load_exported(out_dir: str, params, inputs: Mapping[str, Any]):
    """The jax.export.Exported written by _save_exported; `params` and
    `inputs` give the structure of the program's (params, batch) argument."""
    import jax
    from jax import export as jax_export

    with open(os.path.join(out_dir, "forward.json")) as f:
        meta = json.load(f)
    with open(os.path.join(out_dir, "forward.bin"), "rb") as f:
        module = f.read()
    aval = lambda sd: jax.core.ShapedArray(tuple(sd[0]), np.dtype(sd[1]))
    in_avals = tuple(aval(a) for a in meta["in_avals"])
    out_avals = tuple(aval(a) for a in meta["out_avals"])
    in_tree = jax.tree_util.tree_structure(((params, dict(inputs)), {}))
    if in_tree.num_leaves != len(in_avals):
        raise ValueError(f"corrupt serving artifact in '{out_dir}': "
                         f"{in_tree.num_leaves} inputs vs "
                         f"{len(in_avals)} exported")
    return jax_export.Exported(
        fun_name=meta["fun_name"],
        in_tree=in_tree,
        in_avals=in_avals,
        out_tree=jax.tree_util.tree_structure(0),
        out_avals=out_avals,
        _has_named_shardings=True,
        _in_named_shardings=(None,) * len(in_avals),
        _out_named_shardings=(None,) * len(out_avals),
        in_shardings_hlo=(None,) * len(in_avals),
        out_shardings_hlo=(None,) * len(out_avals),
        nr_devices=1,
        platforms=tuple(meta["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=tuple(
            jax_export.DisabledSafetyCheck.custom_call(c)
            for c in meta["disabled_custom_calls"]
        ),
        mlir_module_serialized=module,
        calling_convention_version=meta["calling_convention_version"],
        module_kept_var_idx=tuple(meta["module_kept_var_idx"]),
        uses_global_constants=meta["uses_global_constants"],
        _get_vjp=None,
    )


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------


def export_serving(
    gnn,
    params,
    meta: BatchMeta,
    arrays: Mapping[str, np.ndarray],
    out_dir: str,
    *,
    compute_dtype=None,
    platforms: Optional[Sequence[str]] = None,
    description: Optional[Mapping[str, Any]] = None,
) -> str:
    """Compile gnn.apply at `meta`'s shapes and write the artifact dir.

    arrays: one example batch (only shapes/dtypes are used for the input
    signature; labels are stripped). platforms: jax.export lowering
    platforms, e.g. ("cuda",); default = current backend. description: the
    raw model-description dict — stored in the artifact so
    `ServingModel.build_batch` can batch raw samples without external
    files.
    """
    import jax
    from jax import export as jax_export

    inputs = _serving_arrays(arrays)
    model_ir = gnn.ir

    def fwd(p, batch):
        return gnn.apply(p, batch, meta, compute_dtype=compute_dtype)

    specs = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        (params, dict(inputs)),
    )
    kw = {}
    if platforms is not None:
        kw["platforms"] = tuple(platforms)
    # the Pallas (Triton) flash-GAT kernels serialize as custom calls to
    # this target; jax.export's safety check rejects unknown custom calls
    # unless the target is explicitly allowed. These are OUR kernels, and
    # the artifact is platform-tagged, so allowing them is sound.
    kw["disabled_checks"] = [
        jax_export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton"),
        jax_export.DisabledSafetyCheck.custom_call("Sharding"),
    ]
    exported = jax_export.export(jax.jit(fwd), **kw)(*specs)
    os.makedirs(out_dir, exist_ok=True)
    _save_exported(exported, out_dir)

    host_params = jax.tree.map(np.asarray, params)
    leaves: List[np.ndarray] = []
    tree = _encode_tree(host_params, leaves)
    np.savez(
        os.path.join(out_dir, "params.npz"),
        **{f"p{i:05d}": a for i, a in enumerate(leaves)},
    )
    with open(os.path.join(out_dir, "params_tree.json"), "w") as f:
        json.dump(tree, f)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(_meta_to_json(meta), f, indent=1)

    if description is not None:
        dims = {
            f.name: f.size for e in model_ir.entities for f in e.features
        }
        dims.update(
            {a.name: a.edge_param_dim for a in model_ir.adjacency_info()}
        )
        with open(os.path.join(out_dir, "model_description.json"), "w") as f:
            json.dump({"description": dict(description), "dimensions": dims}, f)

    label_name, _, denorm = model_ir.output_info()
    domain = infer_label_domain(model_ir)
    manifest = {
        "format": FORMAT_VERSION,
        "jax_version": jax.__version__,
        "platforms": list(exported.platforms),
        "label_name": label_name,
        "denormalization": denorm,
        "label_domain": list(domain),
        "compute_dtype": str(compute_dtype) if compute_dtype is not None else None,
        "inputs": {
            k: {"shape": list(np.shape(v)), "dtype": str(np.asarray(v).dtype)}
            for k, v in inputs.items()
        },
    }
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


# --------------------------------------------------------------------------
# load / run
# --------------------------------------------------------------------------


class ServingModel:
    """A reloaded artifact: `predict(arrays)` runs the frozen program and
    applies the registered denormalization; `trim(preds, arrays)` drops
    padding rows of the prediction domain."""

    def __init__(
        self,
        exported,
        params,
        meta: BatchMeta,
        manifest: Mapping,
        description: Optional[Mapping[str, Any]] = None,
    ):
        self._exported = exported
        self.params = params
        self.meta = meta
        self.manifest = dict(manifest)
        self.label_name = manifest["label_name"]
        self.label_domain = tuple(manifest["label_domain"])
        self._denorm = self._resolve_denorm(manifest.get("denormalization"))
        self._description = description
        self._ir = None

    @property
    def ir(self):
        """The model IR re-parsed from the stored description (None when the
        artifact was exported without one)."""
        if self._ir is None and self._description is not None:
            from .frontend import parse_model_description

            self._ir = parse_model_description(
                self._description["description"],
                self._description["dimensions"],
            )
        return self._ir

    @staticmethod
    def _resolve_denorm(name) -> Optional[Callable]:
        if not name:
            return None
        from .utils.registry import normalizations

        fn = normalizations().get(name)
        if fn is None:
            import logging

            logging.getLogger("ignnition_tpu").warning(
                "denormalization '%s' is not registered in this process; "
                "serving outputs stay normalized",
                name,
            )
        return fn

    def expected_inputs(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        return {
            k: (tuple(v["shape"]), v["dtype"])
            for k, v in self.manifest["inputs"].items()
        }

    def _check(self, arrays: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        want = self.expected_inputs()
        batch = {}
        for k, (shape, dtype) in want.items():
            if k not in arrays:
                raise ValueError(f"serving batch is missing input '{k}'")
            a = np.asarray(arrays[k])
            if tuple(a.shape) != shape:
                raise ValueError(
                    f"input '{k}' has shape {tuple(a.shape)}, artifact was "
                    f"exported for {shape}; rebuild the batch to the exported "
                    "meta (repad_to_meta) or re-export at the new shape"
                )
            batch[k] = a.astype(dtype, copy=False)
        return batch

    def predict(
        self, arrays: Mapping[str, np.ndarray], denormalize: bool = True
    ) -> np.ndarray:
        batch = self._check(arrays)
        preds = np.asarray(self._exported.call(self.params, batch))
        if denormalize and self._denorm is not None:
            preds = np.asarray(self._denorm(preds, self.label_name))
        return preds

    def trim(
        self, preds: np.ndarray, arrays: Mapping[str, np.ndarray]
    ) -> np.ndarray:
        kind, name = self.label_domain
        if kind == "entity":
            return preds[np.asarray(arrays[f"node_mask_{name}"]) > 0]
        if kind == "edge":
            perm = arrays.get("label_perm")
            if perm is not None:  # original insertion-order edge order
                preds = preds[np.asarray(perm)]
            n = int(np.sum(np.asarray(arrays[f"edge_mask_{name}"]) > 0))
            return preds[:n]
        return preds

    def build_batch(self, samples) -> Dict[str, np.ndarray]:
        """Batch raw GraphSamples directly to the exported shapes (pinned
        via build_batch(target=meta)). Needs the stored model description.

        The result may carry keys the program doesn't consume (e.g.
        `label_perm` for edge-domain models — `trim` uses it to restore the
        samples' original edge order); `predict` picks only the exported
        inputs."""
        if self.ir is None:
            raise ValueError(
                "this artifact was exported without its model description; "
                "batch inputs externally with build_batch(target=meta)"
            )
        from .data.graph import build_batch as _build

        arrays, _ = _build(samples, self.ir, training=False, target=self.meta)
        return arrays

    def predict_samples(self, samples, denormalize: bool = True) -> np.ndarray:
        """Batch raw samples, run the artifact, trim padding rows (edge-domain
        outputs come back in the samples' original edge order)."""
        arrays = self.build_batch(samples)
        return self.trim(self.predict(arrays, denormalize=denormalize), arrays)


def load_serving(out_dir: str) -> ServingModel:
    with open(os.path.join(out_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported serving artifact format {manifest.get('format')}"
        )
    with np.load(os.path.join(out_dir, "params.npz")) as z:
        leaves = [z[f"p{i:05d}"] for i in range(len(z.files))]
    with open(os.path.join(out_dir, "params_tree.json")) as f:
        params = _decode_tree(json.load(f), leaves)
    exported = _load_exported(
        out_dir, params, {k: 0 for k in manifest["inputs"]}
    )
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = _meta_from_json(json.load(f))
    description = None
    desc_path = os.path.join(out_dir, "model_description.json")
    if os.path.exists(desc_path):
        with open(desc_path) as f:
            description = json.load(f)
    return ServingModel(exported, params, meta, manifest, description)
