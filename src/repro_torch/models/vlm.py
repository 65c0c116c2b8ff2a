"""InternVL2 language backbone with a stub vision frontend (port of
``repro.models.vlm``; internvl2-26b).

As in the reference, the vision encoder (InternViT-6B) is a stub: the
caller hands in patch embeddings (M, B, P, vision_embed_dim), and this
module holds what follows them: the MLP projector (layer norm, then a
linear map into the model width, in plain PyTorch: the reference uses no
Pallas kernel there) and the InternLM2 decoder, which is dense's.

The prefill position stream is [P image-patch positions][prompt
tokens]: a chunk position below P takes the projected patch embedding at
that position (its token id is ignored), a later one its token
embedding, and the chunk body is dense's (``_prefill_chunk_embeds``).
After the prefill the patches live in the KV cache, so decode, the cache
and the carry are dense's.

Training and a prefill from scratch (``forward``, ``text_logits``,
``prefill``) put the projected patches at positions [0, P) and the
tokens after them, then run dense's whole-sequence path
(``dense.forward(inputs_embeds=...)``, ``dense.prefill_embeds``): no
kernel, as in the reference.

On a mesh the backbone takes dense's rules (``models/shardings.py``):
heads and the FFN over "model" where they divide, the head whole where
the vocab does not; the projector stays whole on every rank.  A mesh
rank draws only its shard (``init(..., cut=shardings.vlm_cut(...))``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.common import MergedParams, draw_leaf, training_params

torch_dtype = dense.torch_dtype

# projector leaves stored in cfg.dtype (``layers.linear`` casts them to the
# activation dtype at every call); its norm scale stays in param_dtype
PROJECTOR_MATMUL = ("w1", "b1")


def _shapes(cfg: ModelConfig) -> dict:
    """(shape, init) of every leaf: dense's tree (read off
    ``dense.build_params``) and the projector's."""
    tree = dense.build_params(cfg, lambda shape, init="normal": (tuple(shape), init))
    m, pd, d = cfg.num_instances, cfg.vision_embed_dim, cfg.d_model
    tree["projector"] = {"w1": ((m, pd, d), "fan_in"), "b1": ((m, d), "zeros"),
                         "norm": ((m, pd), "ones")}
    return tree


def _dtype(cfg: ModelConfig, group: str, name: str) -> torch.dtype:
    matmul = dense.MATMUL_LEAVES if group == "layers" else PROJECTOR_MATMUL
    return torch_dtype(cfg.dtype if name in matmul else cfg.param_dtype)


def storage_dtypes(cfg: ModelConfig, tree: dict) -> dict:
    """Cast a parameter tree to the port's storage dtypes."""
    tree = dict(tree)
    proj = tree.pop("projector")
    out = dense.storage_dtypes(cfg, tree)
    out["projector"] = {k: v.to(_dtype(cfg, "projector", k)) for k, v in proj.items()}
    return out


def init(cfg: ModelConfig, generator, device: torch.device, cut=None, *,
         train: bool = False) -> MergedParams:
    """Random parameters with the reference's distributions, in the
    port's storage dtypes, on ``device``, each leaf drawn a layer at a
    time (``common.draw_leaf``: internvl2-26b's 48-layer backbone is
    ~40 GB an instance in bf16, twice that in f32).  ``generator``: one
    ``torch.Generator`` or a list of M, one an instance (the model then
    equals M one-instance draws merged, bit for bit, written in place).
    ``cut`` (``shardings.vlm_cut``) keeps a mesh rank's slice of each
    drawn layer.  ``train`` gives the trainable form (every leaf drawn in
    param_dtype, requiring a gradient: ``common.training_params``)."""
    dev, par = torch.device(device), torch_dtype(cfg.param_dtype)
    tree = {}
    for group, leaf in _shapes(cfg).items():
        if isinstance(leaf, dict):
            tree[group] = {k: draw_leaf(k, shape, init_,
                                        par if train else _dtype(cfg, group, k),
                                        group == "layers", generator, dev, par,
                                        cut if group == "layers" else None)
                           for k, (shape, init_) in leaf.items()}
        else:
            shape, init_ = leaf
            tree[group] = draw_leaf(group, shape, init_, par, False, generator, dev, par, cut)
    return training_params(cfg, tree) if train else MergedParams(tree)


def project_image(cfg: ModelConfig, params, image_embeds, groups: L.LaneGroups | None = None):
    """Stub-ViT patch embeddings (M, B, P, vision_dim) -> the model width
    (M, B, P, D): layer norm, then linear (row i on instance
    ``groups.t[i]`` under lane groups)."""
    pp = params["projector"]
    norm, b1 = pp["norm"], pp["b1"]
    if groups is not None:
        norm, b1 = groups.rows(norm), groups.rows(b1)
    x = L.layer_norm(image_embeds.to(torch_dtype(cfg.dtype)), norm, None, cfg.norm_eps)
    return L.linear(x, pp["w1"], b1, groups)


def _combined(cfg: ModelConfig, params, tokens, image_embeds):
    """The whole-sequence inputs (M, B, P + S, D): the projected patches,
    then the token embeddings, and their positions 0 .. P + S - 1."""
    x = torch.cat([project_image(cfg, params, image_embeds),
                   dense._embed_in(cfg, params, tokens)], dim=2)
    m, b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(m, b, s)
    return x, positions


def forward(cfg: ModelConfig, params, tokens, image_embeds, *, remat: bool = False):
    """Logits over every position, the image prefix and the text (M, B,
    P + S, V) f32; :func:`text_logits` slices the text."""
    x, positions = _combined(cfg, params, tokens, image_embeds)
    return dense.forward(cfg, params, tokens, inputs_embeds=x, positions=positions,
                         remat=remat)


def text_logits(cfg: ModelConfig, params, tokens, image_embeds, *, remat: bool = False):
    """Logits of the text positions (M, B, S, V), aligned with the labels."""
    p = image_embeds.shape[2]
    return forward(cfg, params, tokens, image_embeds, remat=remat)[:, :, p:]


def prefill(cfg: ModelConfig, params, tokens, image_embeds, *, cache_len: int | None = None):
    """A whole prompt, image patches then tokens: (last logits (M, B, V)
    f32, dense's KVCache over the P + S positions), dense's shell."""
    x, positions = _combined(cfg, params, tokens, image_embeds)
    return dense.prefill_embeds(cfg, params, x, positions, cache_len=cache_len)


def prefill_chunk(cfg: ModelConfig, params, batch, carry, offset, *,
                  instances: list[int] | None = None, tp=None) -> dict:
    """One chunk of a state-carrying prefill.  batch["tokens"] (M, B, C)
    at positions offset .. offset + C - 1, batch["image_embeds"] (M, B, P,
    vision_dim); a position below P takes the projected patch embedding at
    that position, a later one its token embedding.  Then dense's chunk
    body (cache appended in place; ``valid``, ``instances`` and ``tp`` as
    there)."""
    tokens, img = batch["tokens"], batch["image_embeds"]
    m, b, c = tokens.shape
    p = img.shape[2]
    positions = offset[..., None] + torch.arange(c, dtype=offset.dtype, device=offset.device)
    groups = None
    if instances is not None:
        groups = L.LaneGroups(instances, params["final_norm"].shape[0], tokens.device)
    tok_x = dense._embed_in(cfg, params, tokens, instances)
    img_x = project_image(cfg, params, img, groups)                   # (M, B, P, D)
    idx = positions.clamp(0, p - 1).long()[..., None].expand(m, b, c, img_x.shape[-1])
    img_x = img_x.gather(2, idx)
    x = torch.where((positions < p)[..., None], img_x.to(tok_x.dtype), tok_x)
    return dense._prefill_chunk_embeds(cfg, params, x, carry, offset, valid=batch.get("valid"),
                                       instances=instances, tp=tp)


decode_step = dense.decode_step
decode_step_sample = dense.decode_step_sample
make_cache = dense.make_cache
cache_axes = dense.cache_axes
init_chunk_carry = dense.init_chunk_carry
chunk_carry_axes = dense.chunk_carry_axes
