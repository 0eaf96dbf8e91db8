"""Weights made from the seed, on the device, in the type they are served
in, the same bits for the program and for the reference.

``leaves(cfg)`` lists an architecture's leaves in draw order, by the
benchmark's own names, with shape, dtype and how each is drawn; ``fill``
draws them one after the other from one ``torch.Generator`` on the
device, each into the tensor its caller gives (the program's parameter,
or a fresh tensor for the reference), so both sides get the same values.

Scales keep activations near unit size at any width: a product's weight
is normal with standard deviation fan_in ** -0.5, the embedding standard
normal, norm gains 1 + 0.1 normal (so that a gain left out shows), the
router's logits of unit spread. A configuration without a router bias
gets zeros there.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(cfg: dict) -> dict:
    """The sizes of a GQA mixture-of-experts LM config (Hugging Face
    keys)."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    return dict(D=d, H=h, Hkv=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // h,
                F=cfg["intermediate_size"], E=cfg["num_local_experts"],
                K=cfg["num_experts_per_tok"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"])


def leaves(cfg: dict) -> list[tuple[str, tuple, torch.dtype, str, float]]:
    """(name, shape, dtype, kind, std) in draw order; kind is ``normal``,
    ``gain`` (1 + std * normal) or ``zeros``."""
    z = dims(cfg)
    D, H, Hkv, hd, F, E, V = (z[k] for k in
                              ("D", "H", "Hkv", "hd", "F", "E", "V"))
    dt = DTYPES[cfg["torch_dtype"]]
    f32 = torch.float32
    out = [("embed", (V, D), dt, "normal", 1.0)]
    for i in range(z["L"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (D,), f32, "gain", 0.1),
                (p + "attn.wq", (D, H * hd), dt, "normal", D ** -0.5),
                (p + "attn.wk", (D, Hkv * hd), dt, "normal", D ** -0.5),
                (p + "attn.wv", (D, Hkv * hd), dt, "normal", D ** -0.5),
                (p + "attn.wo", (H * hd, D), dt, "normal", (H * hd) ** -0.5),
                (p + "ln2", (D,), f32, "gain", 0.1),
                (p + "moe.router", (D, E), f32, "normal", D ** -0.5),
                (p + "moe.router_bias", (E,), f32, "zeros", 0.0),
                (p + "moe.w1", (E, D, F), dt, "normal", D ** -0.5),
                (p + "moe.w3", (E, D, F), dt, "normal", D ** -0.5),
                (p + "moe.w2", (E, F, D), dt, "normal", F ** -0.5)]
    out += [("final_ln", (D,), f32, "gain", 0.1),
            ("lm_head", (D, V), dt, "normal", D ** -0.5)]
    return out


@torch.no_grad()
def fill(cfg: dict, seed: int, device, tensor_for) -> None:
    """Draw every leaf of ``cfg`` from ``seed`` on ``device`` into
    ``tensor_for(name, shape, dtype)``, which returns the tensor to fill
    (of that shape and dtype, contiguous, on ``device``)."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    for name, shape, dtype, kind, std in leaves(cfg):
        t = tensor_for(name, shape, dtype)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, "
                             f"want {shape} {dtype} contiguous")
        if kind == "zeros":
            t.zero_()
        elif kind == "gain":
            t.normal_(1.0, std, generator=gen)
        else:
            t.normal_(0.0, std, generator=gen)


def make(cfg: dict, seed: int, device, dtype=None) -> dict:
    """Every leaf as a fresh tensor, cast to ``dtype`` when given (the
    reference's float32 copy of the served weights)."""
    out = {}

    def tensor_for(name, shape, dt):
        t = torch.empty(shape, dtype=dt, device=device)
        out[name] = t
        return t
    fill(cfg, seed, device, tensor_for)
    if dtype is not None:
        for k in out:
            out[k] = out[k].to(dtype)
    return out
