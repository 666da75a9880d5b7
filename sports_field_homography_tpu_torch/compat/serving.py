"""Self-contained serving artifacts with ``torch.export`` (port of
``compat/serving.py``).

The predict CLI's device program (``cli/engine.predict_fn``: uint8 frames
divided by 255 in the program, BN folded as the bundle was built, the kept
outputs pruned) is traced with ``torch.export`` into one program whose
weights, court labels, value table and court points of interest are its
own constants.  Loading it needs neither the model code nor a checkpoint:
only the ``sfh`` operators (``ops/library.py``), whose implementations are
the kernels on CUDA and the plain versions on the CPU.

Artifact layout (one directory):
  * ``program.pt2`` -- ``torch.export.save`` of ``predict(x: uint8 or
    float32 [B, H, W, 3]) -> {theta, consist_score, ...}``;
  * ``meta.json``   -- the JAX artifact's keys: format, platforms,
    weights_dtype, input spec, outputs, config.

An artifact runs on the device type it was exported on (``platforms``), so
a CUDA artifact is exported on the card that will serve it.  The JAX
artifact's PJRT sidecars (``module.mlir.bc``, ``compile_options.pb``,
``io_spec.txt``) feed its C++ runtime; this format has none
(``meta["pjrt_sidecars"]``).
"""
from __future__ import annotations

import collections
import copy
import json
import os
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import library

__all__ = ["export_predict", "save_serving", "load_serving", "read_meta", "bf16_castable",
           "POLY_BATCH_MAX"]

_PROGRAM = "program.pt2"
_META = "meta.json"
# the largest batch a poly_batch artifact takes (the default serving bucket cap
# is 32; the kernels' int32 pixel index allows ~9000 frames at 640x360)
POLY_BATCH_MAX = 1024
_OUTPUTS = ("segm_mask", "warp_mask", "theta", "consist_score", "poi")
_aten = torch.ops.aten
# ops that pass a tensor's values through unchanged (a view or a copy)
_PASS_THROUGH = {_aten.permute.default, _aten.slice.Tensor, _aten.select.int,
                 _aten.t.default, _aten.transpose.int, _aten.view.default,
                 _aten.reshape.default, _aten.squeeze.dim, _aten.unsqueeze.default,
                 _aten.alias.default, _aten.detach.default, _aten.contiguous.default,
                 _aten.clone.default}


class _Program(nn.Module):
    """``predict_fn`` as a module: the model's weights are its parameters,
    the court constants tensors the function closes over."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, frames: torch.Tensor):
        return self.fn(frames)


def _cast_dtype(node) -> Optional[torch.dtype]:
    """The dtype a cast node converts to, or None for another node."""
    if node.target is _aten._to_copy.default:
        return node.kwargs.get("dtype")
    if node.target in (_aten.to.dtype, _aten.to.dtype_layout):
        return node.args[1] if len(node.args) > 1 else node.kwargs.get("dtype")
    return None


def _only_cast_to(node, dtype: torch.dtype) -> bool:
    """True where every use of ``node``'s values is a cast to ``dtype``,
    through views and copies."""
    if not node.users:
        return False
    for user in node.users:
        if user.target is _aten._assert_tensor_metadata.default:    # a cast's dtype check
            continue
        if user.target in _PASS_THROUGH and user.args[0] is node:
            if not _only_cast_to(user, dtype):
                return False
        elif _cast_dtype(user) != dtype:
            return False
    return True


def bf16_castable(ep) -> list:
    """The float32 parameters of an exported program that it uses only
    after a cast to bf16 (through views): stored in bf16, every output
    stays bit-equal, since the program then casts bf16 to bf16."""
    sig = ep.graph_signature
    params = dict(ep.named_parameters())
    out = []
    for node in ep.graph.nodes:
        name = sig.inputs_to_parameters.get(node.name) if node.op == "placeholder" else None
        if name is not None and params[name].dtype == torch.float32 \
                and _only_cast_to(node, torch.bfloat16):
            out.append(name)
    return out


def _drop_noop_casts(ep):
    """Remove the casts to a tensor's own dtype (every ``.float()`` of an
    f32 tensor) and the dtype assertions tracing puts beside each cast:
    they compute nothing, and a call of each from the graph costs host
    time (``PERF.md`` section 6, the serving artifact)."""
    graph = ep.graph
    for node in list(graph.nodes):
        if node.target is _aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    for node in list(graph.nodes):
        if _cast_dtype(node) is not None and node.target is not _aten._to_copy.default \
                and len(node.args) <= 2 and not node.kwargs \
                and node.args[0].meta["val"].dtype == _cast_dtype(node):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()


def _export(model, fn, x, poly_batch: bool):
    dynamic = ({0: torch.export.Dim("b", min=1, max=POLY_BATCH_MAX)},) if poly_batch else None
    with torch.no_grad():
        return torch.export.export(_Program(model, fn), (x,), dynamic_shapes=dynamic,
                                   strict=False)


def export_predict(bundle, consistency: bool, project_poi: bool,
                   keep: Optional[Sequence[str]], batch_size: int,
                   input_dtype: str = "uint8", poly_batch: bool = False):
    """Export the predict program with everything in it.

    ``bundle``: a ``cli.engine.ModelBundle`` on the device the artifact will
    serve on (BN folded as desired).  ``keep``: the outputs to return (None:
    all of ``segm_mask, warp_mask, theta, consist_score, poi``); ``poi`` only
    with ``project_poi``, ``consist_score`` only with ``consistency``.

    ``poly_batch``: a symbolic batch dimension (1..``POLY_BATCH_MAX``), so
    one artifact serves any batch; ``batch_size`` is recorded as the
    recommended size.

    The traced casts of a tensor to its own dtype, and their dtype
    assertions, are removed from the graph (``_drop_noop_casts``).

    Weights: where the model computes in bf16, every float parameter that the
    program uses only after a cast to bf16 (the conv weights, the stem's
    and the 1x1 head's bias) is stored in bf16, found from the exported
    graph (``bf16_castable``) and exported again; the others (BN vectors,
    the K2 and K3 biases, which are added in f32, and the STN's f32 linear
    head) stay f32.  Every output is then bit-equal to the live program.
    The caller's model is left as it was (the program holds a copy).

    Returns ``(torch.export.ExportedProgram, meta dict)``.
    """
    from ..cli.engine import predict_fn    # here: load_serving imports no model code

    if input_dtype not in ("uint8", "float32"):
        raise ValueError(f"input_dtype is uint8 or float32, not {input_dtype}")
    keep = [k for k in (_OUTPUTS if keep is None else keep)
            if (k != "poi" or project_poi) and (k != "consist_score" or consistency)]
    w, h = bundle.config.target_size
    dtype = {"uint8": torch.uint8, "float32": torch.float32}[input_dtype]
    example = 2 if poly_batch and batch_size < 2 else batch_size    # a traced batch of 1 specializes
    x = torch.zeros((example, h, w, 3), dtype=dtype, device=bundle.device)

    model = bundle.model
    ep = _export(model, predict_fn(bundle, consistency, keep), x, poly_batch)
    castable = bf16_castable(ep) if model.dtype == torch.bfloat16 else []
    if castable:
        model = copy.deepcopy(model)
        params = dict(model.named_parameters())
        for name in castable:
            name = name.split(".", 1)[1]               # drop _Program's "model."
            params[name].data = params[name].data.to(torch.bfloat16)
        bundle = copy.copy(bundle)
        bundle.model = model
        ep = _export(model, predict_fn(bundle, consistency, keep), x, poly_batch)
    _drop_noop_casts(ep)
    ep.example_inputs = None        # the zero frames traced on: not saved with the program
    counts = dict(collections.Counter(str(p.dtype).removeprefix("torch.")
                                      for p in ep.state_dict.values() if p.is_floating_point()))
    cfg = bundle.config
    meta = {
        "format": "torch.export",
        "torch_version": torch.__version__,
        "platforms": [bundle.device.type],
        "weights_dtype": "bfloat16" if "bfloat16" in counts else "float32",
        "weight_tensors": counts,
        "input": {"shape": ["b" if poly_batch else batch_size, h, w, 3],
                  "dtype": input_dtype,
                  "layout": "NHWC",
                  "poly_batch": bool(poly_batch),
                  "poly_batch_max": POLY_BATCH_MAX if poly_batch else None,
                  "recommended_batch": int(batch_size),
                  "note": "uint8 inputs are normalized (x/255) in-program"},
        "outputs": sorted(ep.call_spec.out_spec.context),
        "config": {
            "target_size": list(cfg.target_size),
            "unet_size": list(cfg.unet_size),
            "warp_size": list(cfg.warp_size),
            "mask_classes": int(cfg.mask_classes),
            "resnet_name": cfg.resnet_name,
            "resnet_input": cfg.resnet_input,
            "unet_bilinear": bool(cfg.unet_bilinear),
            "compute_dtype": str(model.dtype).removeprefix("torch."),
            "consistency": bool(consistency),
            "project_poi": bool(project_poi),
        },
        "pjrt_sidecars": None,     # module.mlir.bc etc.: JAX's C++ runtime only
        "operators": sorted({str(n.target) for n in ep.graph.nodes
                             if n.op == "call_function" and str(n.target).startswith("sfh.")}),
    }
    return ep, meta


def save_serving(dst_dir: str, ep, meta: dict) -> str:
    """Write ``program.pt2`` and ``meta.json`` into ``dst_dir``."""
    os.makedirs(dst_dir, exist_ok=True)
    torch.export.save(ep, os.path.join(dst_dir, _PROGRAM))
    with open(os.path.join(dst_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return dst_dir


def read_meta(src_dir: str) -> dict:
    with open(os.path.join(src_dir, _META)) as f:
        meta = json.load(f)
    if meta.get("format") != "torch.export":
        raise ValueError(f"{src_dir}: a {meta.get('format')!r} artifact, not torch.export "
                         "(the JAX package's artifacts are served by the JAX server)")
    return meta


def load_serving(src_dir: str, device: Optional[str] = None):
    """Load a serving artifact -> ``(fn, meta)``.

    ``fn(x)`` takes a tensor with the artifact's input spec on its device
    and returns the output dict.  ``device`` (default: the artifact's
    platform) must be the device type the artifact was exported on: a CUDA
    artifact refuses the CPU and the reverse, before the program loads.  A
    CUDA artifact of an f32 model turns TF32 off, as ``build_model`` does.
    Nothing of the models or the CLIs is imported; the ``sfh`` operators
    are registered (``ops/library.load_operators``).
    """
    meta = read_meta(src_dir)
    platforms = meta["platforms"]
    dev = torch.device(device if device is not None else platforms[0])
    if dev.type not in platforms:
        raise ValueError(f"{src_dir}: exported for {platforms}, asked to run on {dev.type}; "
                         "export the artifact on the device that serves it")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{src_dir}: a CUDA artifact, and this machine has no CUDA device")
    if dev.type == "cuda" and meta["config"].get("compute_dtype") == "float32":
        # the f32 program as build_model runs it live: cuDNN and cuBLAS in
        # full f32, not TF32 (a process-wide setting, not part of the program)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    library.load_operators()
    module = torch.export.load(os.path.join(src_dir, _PROGRAM)).module()

    def fn(x: torch.Tensor):
        return module(x)

    return fn, meta
