"""CLAP text tower: RoBERTa encoder + 2-layer MLP projection (port of
audioldm_tpu/models/clap_text.py; transformers ``ClapTextModelWithProjection``
module names). Attention is masked, so it takes the plain path of ``sdpa``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from audioldm_tpu_torch.config import ClapTextConfig
from audioldm_tpu_torch.models.nn import ACT, layer_norm, sdpa


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa's pad-aware position ids: ``cumsum(mask) * mask + pad_id``."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class _Linear(nn.Module):
    """Holds one ``dense`` Linear (and optionally its LayerNorm) under the
    transformers names."""


class ClapTextModelWithProjection(nn.Module):
    def __init__(self, cfg: ClapTextConfig = ClapTextConfig()):
        super().__init__()
        self.cfg = cfg
        hs = cfg.hidden_size
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, hs)
        tm.embeddings.position_embeddings = nn.Embedding(cfg.max_position_embeddings, hs)
        tm.embeddings.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, hs)
        tm.embeddings.LayerNorm = nn.LayerNorm(hs, eps=cfg.layer_norm_eps)
        tm.encoder = nn.Module()
        tm.encoder.layer = nn.ModuleList()
        for _ in range(cfg.num_hidden_layers):
            lay = nn.Module()
            lay.attention = nn.Module()
            lay.attention.self = nn.Module()
            for name in ("query", "key", "value"):
                setattr(lay.attention.self, name, nn.Linear(hs, hs))
            lay.attention.output = _Linear()
            lay.attention.output.dense = nn.Linear(hs, hs)
            lay.attention.output.LayerNorm = nn.LayerNorm(hs, eps=cfg.layer_norm_eps)
            lay.intermediate = _Linear()
            lay.intermediate.dense = nn.Linear(hs, cfg.intermediate_size)
            lay.output = _Linear()
            lay.output.dense = nn.Linear(cfg.intermediate_size, hs)
            lay.output.LayerNorm = nn.LayerNorm(hs, eps=cfg.layer_norm_eps)
            tm.encoder.layer.append(lay)
        tm.pooler = _Linear()
        tm.pooler.dense = nn.Linear(hs, hs)
        self.text_model = tm
        self.text_projection = nn.Module()
        self.text_projection.linear1 = nn.Linear(hs, cfg.projection_dim)
        self.text_projection.linear2 = nn.Linear(cfg.projection_dim, cfg.projection_dim)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> dict:
        """Returns ``{"text_embeds", "pooler_output", "last_hidden_state"}``."""
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).long()
        input_ids = input_ids.long()
        emb = self.text_model.embeddings
        pos = roberta_position_ids(input_ids, cfg.pad_token_id)
        h = emb.word_embeddings(input_ids) + emb.position_embeddings(pos) + emb.token_type_embeddings(torch.zeros_like(input_ids))
        h = layer_norm(h, emb.LayerNorm)
        ext_mask = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        act = ACT[cfg.hidden_act]
        b, n, _ = h.shape
        for lay in self.text_model.encoder.layer:
            sa = lay.attention.self
            q, k, v = (p(h).view(b, n, nh, hd).transpose(1, 2) for p in (sa.query, sa.key, sa.value))
            a = sdpa(q, k, v, ext_mask).transpose(1, 2).reshape(b, n, cfg.hidden_size)
            ao = lay.attention.output
            h = layer_norm(ao.dense(a) + h, ao.LayerNorm)
            inter = act(lay.intermediate.dense(h))
            h = layer_norm(lay.output.dense(inter) + h, lay.output.LayerNorm)
        pooled = torch.tanh(self.text_model.pooler.dense(h[:, 0]))
        proj = self.text_projection
        text_embeds = proj.linear2(ACT[cfg.projection_hidden_act](proj.linear1(pooled)))
        return {"text_embeds": text_embeds, "pooler_output": pooled, "last_hidden_state": h}
