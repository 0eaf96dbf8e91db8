"""Batched serving engine: prefill + greedy decode with a KV cache,
wave-based batching — port of ``repro.serve.engine``.

Requests are grouped into fixed-size waves: every slot prefills together
and decodes in lockstep, and finished sequences are dropped from the
output. A short wave is filled with dummy slots; prompts are left-padded
with token 0, which is then attended (not masked), in an MoE model
routed like any other token (it takes capacity slots), and in zamba2's
Mamba2 blocks and rwkv6's time- and channel-mix fed into the SSM and WKV
states and the token shift like any other token; every row takes
positions 0..S-1 whatever its padding, as in the reference. A zamba2
wave's longest prompt must be at most the SSD chunk (256 tokens) or a
multiple of it, or its prefill raises (``models.mamba2``).
``extra_inputs`` (the reference's: ``{"frames": (B, T, D)}`` for an
encoder-decoder, ``{"vision": ...}`` for a VLM, with B the wave's slots)
join every wave's prefill batch, the same for every wave; without them
the model attends to the zeros of its cache's ``enc_out`` / ``vision``.

A model laid out on a mesh (DTensor parameters, ``models.lm``) serves
on it, one engine a rank with the same requests: the greedy tokens are
read whole on every rank (``full_tensor``), so every rank takes the same
tokens and stopping decisions and returns the same results.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.lm import LM


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = 1


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray


class Engine:
    def __init__(self, model: LM, *, batch_slots: int, max_len: int,
                 extra_inputs: dict | None = None):
        self.model = model
        self.B = batch_slots
        self.max_len = max_len
        self.extra = extra_inputs or {}

    def run_wave(self, requests: list[Request]) -> list[Result]:
        if not 0 < len(requests) <= self.B:
            raise ValueError(f"a wave takes 1..{self.B} requests, got "
                             f"{len(requests)}")
        reqs = list(requests)
        while len(reqs) < self.B:                 # pad with a dummy slot
            reqs.append(Request(uid=-1, prompt=reqs[0].prompt,
                                max_new_tokens=reqs[0].max_new_tokens))
        plen = max(len(r.prompt) for r in reqs)
        prompts = np.zeros((self.B, plen), np.int32)
        for i, r in enumerate(reqs):
            prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": prompts, **self.extra}
        logits, cache = self.model.prefill(batch, self.max_len)
        out = [[] for _ in range(self.B)]
        done = np.zeros((self.B,), bool)
        tok = torch.argmax(logits, dim=-1)
        max_new = max(r.max_new_tokens for r in reqs)
        for step in range(max_new):
            t_np = (tok.full_tensor() if isinstance(tok, DTensor)
                    else tok).cpu().numpy()
            for i, r in enumerate(reqs):
                if not done[i] and step < r.max_new_tokens:
                    out[i].append(int(t_np[i]))
                    if int(t_np[i]) == r.eos_id:
                        done[i] = True
                elif step >= r.max_new_tokens:
                    done[i] = True
            if done.all():
                break
            logits, cache = self.model.decode(cache, tok)
            tok = torch.argmax(logits, dim=-1)
        return [Result(r.uid, np.asarray(o, np.int32))
                for r, o in zip(reqs, out) if r.uid >= 0]

    def serve(self, requests: list[Request]) -> list[Result]:
        """Process a request queue in waves of B slots."""
        results = []
        for i in range(0, len(requests), self.B):
            results.extend(self.run_wave(requests[i:i + self.B]))
        return results
