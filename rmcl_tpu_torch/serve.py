"""Serving (port of ``rmcl_tpu/serve.py``): one task's deterministic
inference over fixed-size wire-format batches, live or as an ahead-of-time
artifact.

``Session`` serves the live ``ViLT`` module on one device, its block weights
cast once to the compute type.  ``export_inference`` traces one task's
inference at a fixed batch shape with ``torch.export`` and serialises the
program: its arguments are ``(params, batch)``, ``params`` the
reference-named state dict of the parts the task reads and ``batch`` the
wire batch of ``batch_spec``, so the artifact holds no parameter (a few tens
of kB whatever the model's size) and serves every checkpoint of the
architecture without the model code.  The program casts the block matrices
to the compute type and normalises the u8 wire inside the graph, as the JAX
artifact does; the block halves (and the attention core of configuration
P) are single nodes, the ``rmcl::`` operators of ``ops/fused_block.py`` and
``ops/attention.py``, which launch the kernels when the program runs on
CUDA tensors, wherever it was exported.  ``load_artifact`` registers those
operators, loads the program and moves it to the serving device;
``ArtifactSession`` serves it.

Both sessions chunk requests into batches of their size and pad a short
chunk by repeating its first request (padded rows are dropped before
returning).  Outputs are float32 numpy arrays; ``postprocess`` turns them
into response records.  Everything runs on the first CUDA device unless the
caller asks for another; without a card only an explicit ``device="cpu"``
runs, on the plain ops.

Tasks:
  mlm   -> (B, T, vocab) logits
  itm   -> (B, 2) match logits
  rank  -> (B,) rank_output score
  vqa   -> (B, vqav2_label_size) logits
  embed -> (B, 128) l2-normalised MoCo projection
"""

from __future__ import annotations

import io
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from rmcl_tpu_torch.models.vilt import ViLT

TASKS = ("mlm", "itm", "rank", "vqa", "embed")
REQUIRED_HEAD = {"mlm": "mlm_score", "itm": "itm_score", "rank": "rank_output",
                 "vqa": "vqa_classifier", "embed": "moco_head"}
# the parts of the model every task's inference reads, besides its head
SERVED_PARTS = ("text_embeddings", "token_type_embeddings", "transformer", "pooler")


def build_infer_fn(cfg, task: str) -> Callable:
    """``(model, batch, block_matrices=None) -> task output`` on the batch's device."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")

    def f(model: ViLT, batch: Dict[str, torch.Tensor], block_matrices=None):
        inf = model.infer(batch, block_matrices)
        if task == "mlm":
            return model.mlm_score(inf["text_feats"])
        if task == "itm":
            return model.itm_score(inf["cls_feats"])
        if task == "rank":
            return model.rank_output(inf["cls_feats"])[:, 0]
        if task == "vqa":
            return model.vqa_classifier(inf["cls_feats"])
        z = model.moco_head(inf["cls_feats"])
        return F.normalize(z.float(), dim=1, eps=1e-12).to(z.dtype)

    return f


def export_meta(cfg, task: str, batch_size: int) -> Dict:
    """What a serving host needs to preprocess requests for an artifact
    (its ``<out_path>.json`` sidecar): the fixed shapes and the host image
    and text pipeline's parameters."""
    return {"task": task, "batch_size": batch_size, "image_dtype": cfg.image_dtype,
            "image_layout": cfg.image_layout, "patch_size": cfg.patch_size,
            "image_size": cfg.image_size, "image_bucket_hw": list(cfg.image_bucket_hw),
            "max_text_len": cfg.max_text_len, "tokenizer": cfg.tokenizer}


def _wire_spec(meta: Dict) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    B, T, P = meta["batch_size"], meta["max_text_len"], meta["patch_size"]
    H, W = meta["image_bucket_hw"]
    u8 = meta["image_dtype"] == "uint8"
    if meta["image_layout"] == "patch":
        ishape = (B, (H // P) * (W // P), P * P * 3)
    elif meta["image_layout"] == "hwc":
        ishape = (B, H, W, 3)
    else:
        raise ValueError(f"image_layout must be 'patch' or 'hwc', got {meta['image_layout']!r}")
    spec = {"image": (ishape, np.dtype(np.uint8 if u8 else np.float32)),
            "text_ids": ((B, T), np.dtype(np.int32)),
            "text_masks": ((B, T), np.dtype(np.int32))}
    if u8:
        spec["image_hw"] = ((B, 2), np.dtype(np.int32))
    return spec


def batch_spec(cfg, batch_size: int) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """Wire-format input signature: name -> (shape, numpy dtype).  The image
    is patch rows (B, gh*gw, P*P*3) or, with ``image_layout="hwc"``, the
    canvas (B, H, W, 3); uint8 with ``image_hw``, or normalised float32."""
    return _wire_spec(export_meta(cfg, "", batch_size))


def serving_device(device=None) -> torch.device:
    """``device``, by default the first CUDA device; a CUDA device on a box
    without one raises (ask for ``"cpu"`` to run the plain ops)."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: serve on a GPU, or pass device='cpu' to run "
                           "the plain ops on the CPU")
    return dev


# ------------------------------------------------------------------ artifact
def _check_task(model: ViLT, task: str) -> None:
    """``task`` is served and ``model`` has its head."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    if not hasattr(model, REQUIRED_HEAD[task]):
        raise ValueError(f"the model has no {REQUIRED_HEAD[task]!r} head: serve "
                         f"{task!r} from a config whose loss_names activate it")


def artifact_params(model: ViLT, task: str) -> Dict[str, torch.Tensor]:
    """The reference-named entries of ``model`` that ``task``'s artifact
    takes: its head and ``SERVED_PARTS``."""
    _check_task(model, task)
    parts = (*SERVED_PARTS, REQUIRED_HEAD[task])
    return {k: v for k, v in model.state_dict().items() if k.split(".", 1)[0] in parts}


class _Task(torch.nn.Module):
    """``model`` serving ``task``: the module ``torch.func.functional_call``
    runs with the artifact's parameters."""

    def __init__(self, cfg, model: ViLT, task: str):
        super().__init__()
        self.model, self.fn = model, build_infer_fn(cfg, task)

    def forward(self, batch):
        return self.fn(self.model, batch)


class _Program(torch.nn.Module):
    """``(params, batch) -> task output``: the exported module.  The model
    is held outside its module tree (in a tuple), so that export lifts no
    parameter into the program: every weight is an argument."""

    def __init__(self, cfg, model: ViLT, task: str):
        super().__init__()
        self.task = (_Task(cfg, model, task),)

    def forward(self, params, batch):
        return torch.func.functional_call(
            self.task[0], {f"model.{k}": v for k, v in params.items()}, (batch,))


# node metadata of the trace that the program does not run on
_TRACE_META = ("stack_trace", "nn_module_stack", "source_fn_stack", "torch_fn", "from_node")


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def export_inference(cfg, model: ViLT, task: str, batch_size: int,
                     out_path: Optional[str] = None, device=None) -> bytes:
    """Serialise ``task``'s inference program at ``batch_size`` (the bytes of
    ``torch.export.save``), traced on ``device`` (default the first CUDA
    device); with ``out_path`` also write it and its ``<out_path>.json``
    sidecar (``export_meta``).  ``model`` gives the architecture and the
    parameters' shapes and types, not their values."""
    dev = serving_device(device)
    params = {k: v.detach().to(dev) for k, v in artifact_params(model, task).items()}
    batch = {k: torch.zeros(shape, dtype=_torch_dtype(dt), device=dev)
             for k, (shape, dt) in batch_spec(cfg, batch_size).items()}
    with torch.no_grad():
        ep = torch.export.export(_Program(cfg, model, task), (params, batch), strict=False)
    ep._example_inputs = None       # the weights themselves: not part of the program
    for node in ep.graph.nodes:     # where each node was traced: the exporting host's paths
        for key in _TRACE_META:
            node.meta.pop(key, None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if out_path:
        with open(out_path, "wb") as fh:
            fh.write(blob)
        with open(out_path + ".json", "w") as fh:
            json.dump(export_meta(cfg, task, batch_size), fh, indent=1)
    return blob


class Artifact:
    """A loaded artifact on its serving device: ``artifact(params, batch)``
    with the state dict (extra entries ignored) and a wire batch (numpy
    arrays or tensors) -> the task output on the device.  ``program`` is the
    ``torch.export.ExportedProgram``.  Every input is checked against the
    program's signature here, once per argument set (``params``, ``wire``),
    and not again by the program on each call."""

    def __init__(self, program, device: torch.device):
        self.program, self.device = program, device
        self._module = program.module()
        self._module.validate_inputs = False       # checked by params() and wire()
        spec = program.call_spec.in_spec
        (params, batch), _ = pytree.tree_unflatten([None] * spec.num_leaves, spec)
        self.param_names, self.batch_names = list(params), list(batch)
        vals = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
        sig = [(tuple(vals[name].shape), vals[name].dtype)
               for name in program.graph_signature.user_inputs]
        self._sig = dict(zip([("params", k) for k in self.param_names]
                             + [("batch", k) for k in self.batch_names], sig))

    def _checked(self, kind: str, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for k, t in tensors.items():
            shape, dtype = self._sig[(kind, k)]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{kind} {k}: the artifact takes {shape} {dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        return tensors

    def params(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The program's parameters of ``state_dict``, checked, on the
        serving device."""
        missing = [k for k in self.param_names if k not in state_dict]
        if missing:
            raise KeyError(f"the artifact takes entries the state dict lacks: {missing}")
        return self._checked("params", {k: state_dict[k].to(self.device)
                                        for k in self.param_names})

    def wire(self, batch) -> Dict[str, torch.Tensor]:
        """A wire batch (numpy arrays or tensors), checked, on the device."""
        return self._checked("batch", {k: torch.as_tensor(batch[k]).to(self.device)
                                       for k in self.batch_names})

    def run(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        """The program on ``params()`` and ``wire()``'s results."""
        with torch.inference_mode():
            return self._module(params, batch)

    def __call__(self, params, batch):
        return self.run(self.params(params), self.wire(batch))


def load_artifact(path_or_bytes, device=None) -> Artifact:
    """An artifact (bytes or a file path) on ``device`` (default the first
    CUDA device): the ``rmcl::`` operators are registered before it is read,
    and the program is moved to the device."""
    from torch.export.passes import move_to_device_pass

    import rmcl_tpu_torch.ops.attention  # noqa: F401  registers rmcl::masked_attention
    import rmcl_tpu_torch.ops.fused_block  # noqa: F401  registers rmcl::attn_half, mlp_half
    dev = serving_device(device)
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    return Artifact(move_to_device_pass(torch.export.load(src), dev), dev)


# ------------------------------------------------------------------ sessions
class _Requests:
    """Requests to fixed-size wire batches: the host pipeline, chunking and
    pad-by-repeat that both sessions share; a session supplies ``forward``
    and ``meta`` (``export_meta``)."""
    meta: Dict
    tokenizer = None
    _transform = None

    @property
    def batch_size(self) -> int:
        return self.meta["batch_size"]

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        raise NotImplementedError

    def infer(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """n wire-format requests (leading axis n) -> (n, ...) float32 outputs,
        in chunks of the session's batch size."""
        n = len(batch["text_ids"])
        if n == 0:
            raise ValueError("infer() needs at least one request")
        B, outs, keys = self.batch_size, [], list(_wire_spec(self.meta))
        for i in range(0, n, B):
            chunk = {k: batch[k][i:i + B] for k in keys}
            m = len(chunk["text_ids"])
            if m < B:   # pad by repeating the chunk's first request
                chunk = {k: np.concatenate([v, np.repeat(v[:1], B - m, axis=0)])
                         for k, v in chunk.items()}
            outs.append(self.forward(chunk).float().cpu().numpy()[:m])
        return np.concatenate(outs, axis=0)

    def _prep_image(self, image) -> np.ndarray:
        """PIL image or HWC uint8 array -> resized array in the wire dtype,
        fitted to the bucket (the JAX package's ``ArtifactSession._prep_image``)."""
        from PIL import Image

        from rmcl_tpu_torch.data import transforms as tr
        m = self.meta
        if self._transform is None:
            self._transform = tr.pixelbert_transform(
                size=m["image_size"], bucket_hw=tuple(m["image_bucket_hw"]),
                out_dtype=m["image_dtype"])
        if isinstance(image, np.ndarray):
            image = Image.fromarray(image)
        longer = int((1333 / 800) * m["image_size"])
        w, h = image.size
        neww, newh = tr.min_max_size(w, h, m["image_size"], longer)
        if neww < 32 or newh < 32:
            # extreme aspect ratios: clamp to one patch instead of refusing
            img = tr.fit_bucket(image.resize((max(neww, 32), max(newh, 32)),
                                             Image.BICUBIC),
                                tuple(m["image_bucket_hw"]))
            if m["image_dtype"] == "uint8":
                return np.asarray(img.convert("RGB"), np.uint8)
            return tr.to_normalized_array(img)
        return self._transform(image)

    def assemble(self, images: Sequence, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        """Raw requests -> wire-format batch (leading axis = len(images)); the
        text truncated to the fixed length, as training tokenizes it."""
        from rmcl_tpu_torch.data.patch_rows import images_to_patch_rows as to_rows
        if self.tokenizer is None:
            raise ValueError("raw requests need a tokenizer")
        m = self.meta
        H, W = m["image_bucket_hw"]
        arrs = [self._prep_image(im) for im in images]
        enc = self.tokenizer(list(texts), max_length=m["max_text_len"],
                             padding="max_length", truncation=True, return_tensors="np")
        if m["image_layout"] == "patch":
            image = to_rows(arrs, H, W, m["patch_size"])
        else:
            image = np.zeros((len(arrs), H, W, 3), arrs[0].dtype)
            for i, a in enumerate(arrs):
                image[i, :a.shape[0], :a.shape[1]] = a[:H, :W]
        batch = {"image": image,
                 "text_ids": np.asarray(enc["input_ids"], np.int32),
                 "text_masks": np.asarray(enc["attention_mask"], np.int32)}
        if m["image_dtype"] == "uint8":
            batch["image_hw"] = np.asarray(
                [[min(a.shape[0], H), min(a.shape[1], W)] for a in arrs], np.int32)
        return batch

    def predict(self, images: Sequence, texts: Sequence[str]) -> np.ndarray:
        """n raw requests (PIL images or HWC uint8 arrays, strings) -> (n, ...)."""
        if len(images) != len(texts):
            raise ValueError("images and texts must pair 1:1")
        if not images:
            raise ValueError("predict() needs at least one request")
        return self.infer(self.assemble(images, texts))


class Session(_Requests):
    """One task served by the live model on one device at a fixed batch size."""

    def __init__(self, cfg, model: ViLT, task: str, batch_size: int,
                 device: torch.device, tokenizer=None):
        _check_task(model, task)
        self.tokenizer, self.meta = tokenizer, export_meta(cfg, task, batch_size)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.fn = build_infer_fn(cfg, task)
        with torch.inference_mode():
            self.block_matrices = self.model.transformer.block_matrices(
                self.model.compute_dtype)

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One full wire-format batch -> the task output on the device."""
        spec = _wire_spec(self.meta)
        for k, (shape, dtype) in spec.items():
            v = batch[k]
            if v.shape != shape or v.dtype != dtype:
                raise ValueError(f"{k}: expected {shape} {dtype}, got {v.shape} {v.dtype}")
        t = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in spec}
        with torch.inference_mode():
            return self.fn(self.model, t, self.block_matrices)


class ArtifactSession(_Requests):
    """An exported artifact served on one device (``load_artifact``) with the
    parameters of a reference-named state dict, moved there once: raw
    requests through the host pipeline training uses, or wire batches
    (``infer``), in chunks of the exported batch size."""

    def __init__(self, artifact, params: Dict[str, torch.Tensor], tokenizer, meta: Dict,
                 device=None):
        self.artifact = (artifact if isinstance(artifact, Artifact)
                         else load_artifact(artifact, device))
        self.device = self.artifact.device
        self.params = self.artifact.params(params)
        self.tokenizer, self.meta = tokenizer, dict(meta)

    @classmethod
    def open(cls, path: str, params: Dict[str, torch.Tensor], tokenizer=None, device=None):
        """The artifact at ``path`` and its ``<path>.json`` sidecar; the
        tokenizer defaults to the one the config trained with."""
        with open(path + ".json") as fh:
            meta = json.load(fh)
        if tokenizer is None:
            from rmcl_tpu_torch.data.tokenizer import get_tokenizer
            tokenizer = get_tokenizer(meta["tokenizer"])
        return cls(path, params, tokenizer, meta, device)

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One full wire-format batch -> the task output on the device."""
        return self.artifact.run(self.params, self.artifact.wire(batch))


def postprocess(task: str, out, tokenizer=None, text_ids=None,
                topk: int = 5) -> List[Dict]:
    """Raw task outputs -> JSON-serializable per-request records (the
    `rmcl serve` response format)."""
    out = np.asarray(out, np.float32)
    recs: List[Dict] = []
    for i in range(out.shape[0]):
        if task == "itm":
            p = np.exp(out[i] - out[i].max())
            p /= p.sum()
            recs.append({"match_prob": float(p[1])})
        elif task == "rank":
            recs.append({"score": float(out[i])})
        elif task == "embed":
            recs.append({"embedding": [float(x) for x in out[i]]})
        elif task == "vqa":
            p = np.exp(out[i] - out[i].max())
            p /= p.sum()
            top = np.argsort(-p)[:topk]
            recs.append({"answers": [[int(j), float(p[j])] for j in top]})
        else:  # mlm: argmax token at each [MASK] position
            ids = np.asarray(text_ids[i])
            mask_id = tokenizer.mask_token_id
            pos = np.where(ids == mask_id)[0]
            pred = out[i].argmax(axis=-1)
            recs.append({"fills": [
                [int(p_), tokenizer.convert_ids_to_tokens(int(pred[p_]))]
                for p_ in pos]})
    return recs


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``torch.save``d reference-named state dict, plain or under
    ``"state_dict"`` as in a Lightning checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)


def seeded_model(cfg, seed: Optional[int] = None) -> ViLT:
    """A ViLT for ``cfg`` with weights drawn from ``seed`` (default cfg.seed)."""
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return ViLT(cfg).init(g)
