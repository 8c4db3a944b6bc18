"""The port's twin of ``__graft_entry__.entry()``: a forward step on the
flagship model (BERT text classifier, BASELINE config #4) and its example
arguments.

    forward, args = entry()
    logits = forward(*args)          # (8, 2) fp32 on the entry's device

The configuration is the reference's: vocabulary 8192, hidden 256, 4 layers,
4 heads, intermediate 1024, 128 positions, 2 labels, dropout 0, bf16 compute
with fp32 parameters; a batch of 8 × 128 ids from ``np.random.RandomState(0)``
with an all-ones mask. Weights come from ``TransformerEncoder.init_weights(0)``
(the reference's come from ``PRNGKey(0)``); ``forward`` takes them as a state
dict, so the reference's tree carried by
:func:`~alink_tpu_torch.dl.convert.flax_to_torch` runs in it too.
"""

from __future__ import annotations

import numpy as np
import torch

from .common.env import resolve_device
from .dl.modules import BertConfig, TransformerEncoder


def entry(device=None):
    """``(forward, (params, input_ids, attention_mask))`` on ``device`` (see
    :func:`~alink_tpu_torch.common.env.resolve_device`). ``forward(params,
    input_ids, attention_mask)`` returns the logits of the model under
    ``params`` (name → tensor; missing names keep the model's own)."""
    dev = resolve_device(device)
    cfg = BertConfig(
        vocab_size=8192, hidden_size=256, num_layers=4, num_heads=4,
        intermediate_size=1024, max_position=128, num_labels=2, dropout=0.0,
    )
    model = TransformerEncoder(cfg).to(dev).init_weights(0).eval()
    rng = np.random.RandomState(0)
    batch, seqlen = 8, 128
    ids = rng.randint(0, cfg.vocab_size, (batch, seqlen)).astype(np.int32)
    mask = np.ones((batch, seqlen), np.int32)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def forward(params, input_ids, attention_mask):
        with torch.no_grad():
            return torch.func.functional_call(
                model, {k: v.to(dev) for k, v in params.items()},
                (input_ids, attention_mask))

    return forward, (params, torch.as_tensor(ids, device=dev),
                     torch.as_tensor(mask, device=dev))
