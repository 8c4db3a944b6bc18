"""Masked-LM pretraining for the BERT stack (port of
``alink_tpu/dl/pretrain.py``).

:func:`pretrain_mlm` trains a :class:`~.modules.TransformerEncoder` on raw
texts with BERT's 80/10/10 masking and a tied-embedding output head
(``logits = states @ tok_emb.weight.T`` in fp32 over every position, the
integer-label softmax cross entropy, its ``sel``-weighted mean), so a user
can produce, save (HF layout, :func:`~.pretrained.save_bert_checkpoint`)
and fine-tune from (``checkpointFilePath``) a domain checkpoint.

The reference's contract, kept:

- masks are numpy draws on the host, seeded per ``(seed, epoch, step)``
  (:func:`_mask_tokens`, :func:`_mask_rows`, copied verbatim), so the
  ``"async"`` and ``"sync"`` feeds give the same batches and a resumed run
  replays the remaining schedule;
- ragged tail batches pad by repeating the last row with the selection
  cleared (unselected positions add exactly zero loss and gradient);
- without a scale knob, the in-memory loop (:func:`_pretrain_legacy`) draws
  whole-batch masks and takes one step a batch; any scale knob (a
  :class:`~.data.CorpusStream`, ``accum_steps`` > 1, ``block_rows``,
  ``checkpoint_every``) switches to the corpus-scale loop
  (:func:`_pretrain_scale`): block-scheduled batches, row-stable masks and
  ordered fp32 chunk gradients (:func:`~.train.make_accum_programs`), so
  streaming ≡ in-memory and accumulated ≡ one large batch, bit for bit;
- ``checkpoint_dir`` saves each epoch (and every ``checkpoint_every``
  optimizer steps mid-epoch) through :class:`~.checkpoint.
  TrainCheckpointManager`; a resumed run restarts at the saved epoch and
  batch, skipping consumed blocks unread.

The optimizer is optax's ``adamw(lr, weight_decay=0.01)``
(:class:`~.train.Optimizer` at a constant rate). Parameters the loss does
not reach (the pooler, the head) get zero gradients, as JAX hands them to
optax: adamw still decays them. The token-type table, which the reference's
tree lacks (the MLM forward passes no token types), is neither trained nor
returned.

Differences from the reference: fresh weights come from
``TransformerEncoder.init_weights(seed)`` (JAX's threefry stream cannot be
reproduced); ``init_params=`` carries the reference's initial tree instead
(a test hook); the loop runs eagerly on :func:`~..common.env.
resolve_device`'s device; one process only (multi-process pretraining is
ROADMAP A3).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.env import resolve_device
from ..common.exceptions import AkIllegalArgumentException
from ..common.metrics import metrics
from ..common.tracing import trace_span
from .data import CorpusStream, scheduled_order
from .modules import BertConfig, TransformerEncoder
from .tokenizer import MASK, Tokenizer
from .train import (Optimizer, _check_single_process, _feed, _host_state,
                    _pad_tail, _placer, _timed_feed, make_accum_programs,
                    make_train_step, new_accumulators)


def _mask_tokens(ids: np.ndarray, attn: np.ndarray, mask_id: int,
                 vocab_size: int, rng: np.random.Generator,
                 mask_prob: float, n_specials: int = 5):
    """BERT masking: select ``mask_prob`` of real tokens; 80% -> [MASK],
    10% -> random token, 10% -> kept. Returns (masked_ids, target_mask).
    Draw order depends on the batch shape — the legacy whole-batch form;
    the corpus-scale loop uses :func:`_mask_rows` instead."""
    sel = (rng.random(ids.shape) < mask_prob) & (attn == 1) \
        & (ids >= n_specials)
    masked = ids.copy()
    r = rng.random(ids.shape)
    masked[sel & (r < 0.8)] = mask_id
    rand_sel = sel & (r >= 0.8) & (r < 0.9)
    masked[rand_sel] = rng.integers(
        n_specials, vocab_size, size=int(rand_sel.sum()))
    return masked, sel


def _mask_rows(ids: np.ndarray, attn: np.ndarray, mask_id: int,
               vocab_size: int, seed_key, full_rows: int, row_start: int,
               mask_prob: float, n_specials: int = 5):
    """Row-stable BERT masking: every random draw is made for the FULL
    effective-batch shape ``(full_rows, seq)`` from the per-(seed, epoch,
    step) generator and then sliced to this chunk's rows — so any
    partition of the batch into micro-steps or process shards reproduces
    the exact same masks (the bit-parity backbone of the corpus-scale
    loop). The replacement tokens are drawn as a full matrix up front for
    the same reason (the legacy form draws ``rand_sel.sum()`` values,
    which couples the stream to other rows' data)."""
    rng = np.random.default_rng(seed_key)
    rows, seq = ids.shape
    lo, hi = row_start, row_start + rows
    sel_d = rng.random((full_rows, seq))[lo:hi]
    r = rng.random((full_rows, seq))[lo:hi]
    repl = rng.integers(n_specials, vocab_size, (full_rows, seq))[lo:hi]
    sel = (sel_d < mask_prob) & (attn == 1) & (ids >= n_specials)
    masked = ids.copy()
    masked[sel & (r < 0.8)] = mask_id
    rand_sel = sel & (r >= 0.8) & (r < 0.9)
    masked[rand_sel] = repl[rand_sel]
    return masked, sel


# parameters of the port's encoder that the reference's MLM tree lacks
_UNUSED = ("type_emb.weight",)


class _MLMHead:
    """The encoder under its tied-embedding head, called as the train steps
    call a model: ``(B, S, V)`` fp32 logits of every position, the final
    states (bf16-rounded, returned as fp32) times the fp32 embedding."""

    def __init__(self, encoder: TransformerEncoder):
        self.encoder = encoder

    def __call__(self, input_ids, attention_mask, *, deterministic=True,
                 rng=None):
        states = self.encoder(input_ids, attention_mask,
                              deterministic=deterministic, rng=rng,
                              return_sequence=True)
        return states @ self.encoder.tok_emb.weight.float().T


def _mlm_loss(weighted: "bool | str" = True):
    """The MLM loss ``f(logits, targets, sel)``: softmax cross entropy of
    every position against its original id, weighted by the selection mask:
    ``sum(ll·sel) / max(sum(sel), 1)``, or with ``weighted="sum"`` the
    unnormalised ``sum(ll·sel)`` that accumulation chunks differentiate."""
    def per_pos(logits, targets):
        v = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, v).float(),
                               targets.reshape(-1).long(), reduction="none")

    if weighted == "sum":
        return lambda logits, t, sel: (
            per_pos(logits, t) * sel.reshape(-1).float()).sum()

    def mean(logits, t, sel):
        w = sel.reshape(-1).float()
        return (per_pos(logits, t) * w).sum() / torch.clamp(w.sum(), min=1.0)
    return mean


def _epoch_loss(losses: List[torch.Tensor]) -> float:
    """The mean of an epoch's step losses, kept on the device until here:
    one sync an epoch, summed in float64 as the reference's host mean."""
    if not losses:
        return float("nan")
    return float(np.mean(torch.stack(losses).double().cpu().numpy()))


def pretrain_mlm(
    texts: "Sequence[str] | CorpusStream",
    *,
    vocab_size: int = 2000,
    hidden_size: int = 128,
    num_layers: int = 2,
    num_heads: int = 4,
    intermediate_size: int = 256,
    max_len: int = 48,
    epochs: int = 30,
    batch_size: int = 64,
    learning_rate: float = 3e-4,
    mask_prob: float = 0.15,
    seed: int = 0,
    tokenizer: Optional[Tokenizer] = None,
    feed: str = "async",
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    accum_steps: int = 1,
    block_rows: Optional[int] = None,
    checkpoint_every: int = 0,
    checkpoint_keep: Optional[int] = None,
    tokenizer_sample: int = 4096,
    init_params=None,
    device=None,
) -> Tuple[BertConfig, Dict[str, torch.Tensor], Tokenizer, List[float]]:
    """MLM-pretrain a BERT encoder on raw texts. Returns ``(cfg, params,
    tokenizer, loss_history)``: ``params`` is the encoder's host state dict,
    which ``save_bert_checkpoint`` writes; ``loss_history`` one mean loss
    an epoch.

    ``texts`` may be a list of strings (in memory) or a
    :class:`~.data.CorpusStream` (streamed; the vocabulary then builds from
    its first ``tokenizer_sample`` rows unless ``tokenizer`` is given).
    ``batch_size`` is the effective optimizer batch; ``accum_steps=N``
    splits it into N ordered micro-chunks whose fp32 gradients add to the
    one-batch step's. ``feed="async"`` assembles (tokenizes, masks, copies)
    batches on a transfer thread ahead of compute, giving the ``"sync"``
    batches. ``checkpoint_dir`` checkpoints each epoch (and every
    ``checkpoint_every`` optimizer steps) and resumes from the newest.

    Runs on ``device`` (see :func:`~..common.env.resolve_device`).
    ``init_params`` (the reference's flax parameter tree, carried by
    :func:`~.convert.flax_to_torch`) replaces the seeded initial weights:
    it exists so that tests can start both packages from the same weights.
    One process only."""
    _check_single_process("pretrain_mlm")
    dev = resolve_device(device)
    accum = int(accum_steps or 1)
    if accum < 1:
        raise AkIllegalArgumentException(
            f"accum_steps must be >= 1, got {accum_steps}")
    if feed not in ("async", "sync"):
        raise AkIllegalArgumentException(f"unknown feed mode {feed!r}")
    streaming = isinstance(texts, CorpusStream)
    # mid-epoch checkpointing is a scale knob too: only the corpus-scale
    # loop resumes at a batch
    scale = streaming or accum > 1 or block_rows is not None \
        or checkpoint_every > 0

    if tokenizer is not None:
        tok = tokenizer
    elif streaming:
        tok = Tokenizer.build(texts.sample_texts(tokenizer_sample),
                              vocab_size=vocab_size)
    else:
        tok = Tokenizer.build(list(texts), vocab_size=vocab_size)
    cfg = BertConfig(
        vocab_size=tok.vocab_size, hidden_size=hidden_size,
        num_layers=num_layers, num_heads=num_heads,
        intermediate_size=intermediate_size, max_position=max_len,
        dropout=0.0, pool="cls")
    model = TransformerEncoder(cfg).to(dev)
    if init_params is None:
        model.init_weights(seed)
    else:
        from .convert import flax_to_torch

        got = model.load_state_dict(flax_to_torch(init_params), strict=False)
        if got.unexpected_keys or set(got.missing_keys) - set(_UNUSED):
            raise AkIllegalArgumentException(
                f"init_params does not fit the encoder: missing "
                f"{got.missing_keys}, unexpected {got.unexpected_keys}")
    # the reference's tree has no token-type table (the MLM forward passes
    # no token types, so flax never creates it): it is neither trained nor
    # returned here either
    opt = Optimizer("adamw", lambda _count: learning_rate,
                    {k: p for k, p in model.named_parameters()
                     if k not in _UNUSED}, weight_decay=0.01)

    ids = attn = None
    if not streaming:
        enc = tok.encode_batch([str(t) for t in texts], max_len=max_len)
        ids = np.asarray(enc["input_ids"], np.int32)
        attn = np.asarray(enc["attention_mask"], np.int32)
    kw = dict(epochs=epochs, batch_size=batch_size, mask_prob=mask_prob,
              seed=seed, feed=feed, checkpoint_dir=checkpoint_dir,
              resume=resume, checkpoint_keep=checkpoint_keep, dev=dev)
    mask_id = tok.vocab[MASK]
    if not scale:
        history = _pretrain_legacy(model, opt, tok, ids, attn, mask_id, **kw)
    else:
        history = _pretrain_scale(
            model, opt, tok, texts, ids, attn, mask_id, streaming=streaming,
            accum=accum, block_rows=block_rows, max_len=max_len,
            checkpoint_every=checkpoint_every, **kw)
    return cfg, {k: v for k, v in _host_state(model).items()
                 if k not in _UNUSED}, tok, history


def _resume(checkpoint_dir, checkpoint_keep, resume, model, opt):
    """``(manager or None, extra of the restored checkpoint or None)``;
    a restored state is loaded into ``model`` and ``opt`` in place."""
    if not checkpoint_dir:
        return None, None
    from .checkpoint import TrainCheckpointManager

    ckpt = TrainCheckpointManager(checkpoint_dir, max_to_keep=checkpoint_keep)
    restored = ckpt.restore_latest() if resume else None
    if restored is None:
        return ckpt, None
    r_params, r_opt, extra = restored
    model.load_state_dict(r_params)
    opt.load_state_dict(r_opt)
    return ckpt, extra


def _pretrain_legacy(model, opt, tok, ids, attn, mask_id, *, epochs,
                     batch_size, mask_prob, seed, feed, checkpoint_dir,
                     resume, checkpoint_keep, dev) -> List[float]:
    """The in-memory loop without scale knobs: whole-batch masking draws,
    one step a batch, each step's loss kept on the device (one sync an
    epoch)."""
    step_fn = make_train_step(_MLMHead(model), opt, _mlm_loss(True),
                              weighted=True)
    ckpt, extra = _resume(checkpoint_dir, checkpoint_keep, resume, model,
                          opt)
    start_epoch = int(extra.get("epoch", -1)) + 1 if extra else 0

    n = ids.shape[0]
    bs = min(batch_size, n)
    steps_per_epoch = -(-n // bs)
    place = _placer(dev)

    history: List[float] = []
    for ep in range(start_epoch, epochs):
        # per-(seed, epoch[, step]) generators: deterministic whatever the
        # feed thread's timing, and a resumed run replays the remaining
        # epochs exactly
        order = np.random.default_rng((seed, ep)).permutation(n)

        def build(s, _order=order, _ep=ep):
            idx = _order[s * bs:(s + 1) * bs]
            r = np.random.default_rng((seed, _ep, s + 1))
            masked, sel = _mask_tokens(
                ids[idx], attn[idx], mask_id, tok.vocab_size, r, mask_prob)
            arrs = [masked, attn[idx], ids[idx]]
            if len(idx) < bs:
                # the tail repeats its last row with the selection cleared
                arrs = _pad_tail(arrs, bs)
                sel = np.concatenate(
                    [sel, np.zeros((bs - len(idx),) + sel.shape[1:], bool)])
            return arrs + [sel]

        ep_losses: List[torch.Tensor] = []
        with trace_span("train.epoch", epoch=ep, rank=0, shards=1):
            t_step = time.perf_counter()
            for s, devs in _timed_feed(_feed(build, place, steps_per_epoch,
                                             mode=feed, device=dev)):
                ep_losses.append(step_fn(
                    {"input_ids": devs[0], "attention_mask": devs[1]},
                    devs[2], devs[3]))
                now = time.perf_counter()
                metrics.observe("train.step_s", now - t_step)
                t_step = now
                metrics.incr("train.steps")
                metrics.incr("train.rows", min(bs, n - s * bs))
            history.append(_epoch_loss(ep_losses))
        if ckpt is not None:
            ckpt.save(ep, _host_state(model), opt.state_dict(),
                      {"epoch": ep, "step": (ep + 1) * steps_per_epoch})
    return history


def _pretrain_scale(model, opt, tok, texts, ids, attn, mask_id, *,
                    streaming, epochs, batch_size, mask_prob, seed, feed,
                    checkpoint_dir, resume, checkpoint_keep, dev, accum,
                    block_rows, max_len, checkpoint_every) -> List[float]:
    """The corpus-scale loop: block-scheduled batches, row-stable masks,
    ordered-chunk gradients (one micro step per chunk, one apply per
    effective batch), mid-epoch checkpoints."""
    from ..common.streaming import stream_map

    n = len(texts)
    if batch_size % accum:
        raise AkIllegalArgumentException(
            f"batch_size={batch_size} is not divisible by accum_steps="
            f"{accum}: micro chunks must tile the effective batch exactly")
    B = max(accum, (min(batch_size, n) // accum) * accum)
    micro = B // accum
    steps_per_epoch = max(1, -(-n // B))
    micro_step, apply_step, _ = make_accum_programs(
        _MLMHead(model), opt, _mlm_loss("sum"), accum)
    acc = new_accumulators(opt.params)

    ckpt, extra = _resume(checkpoint_dir, checkpoint_keep, resume, model,
                          opt)
    start_epoch = start_batch = step = 0
    if extra:
        start_epoch = int(extra.get("epoch", -1)) + 1
        step = int(extra.get("step", 0))
        if "next_batch" in extra:
            # a mid-epoch save: restart that epoch at the next batch; the
            # block schedule is a function of (seed, epoch), so the rest of
            # the order replays and consumed blocks are skipped unread
            start_epoch = int(extra.get("mid_epoch", start_epoch))
            start_batch = int(extra["next_batch"])
    place = _placer(dev)

    history: List[float] = []
    for ep in range(start_epoch, epochs):
        sb = start_batch if ep == start_epoch else 0

        if streaming:
            def payloads(_ep=ep, _sb=sb):
                for s, batch_texts in texts.iter_batches(
                        B, seed, _ep, start_batch=_sb):
                    nreal = len(batch_texts)
                    if nreal < B:  # pad by repeating the last real row
                        batch_texts = list(batch_texts) + \
                            [batch_texts[-1]] * (B - nreal)
                    for k in range(accum):
                        yield (s * accum + k,
                               (s, k, nreal,
                                batch_texts[k * micro:(k + 1) * micro]))
        else:
            if block_rows is not None:
                order = scheduled_order(n, block_rows, seed, ep)
            else:
                order = np.random.default_rng((seed, ep)).permutation(n)

            def payloads(_sb=sb, _order=order):
                for s in range(_sb, steps_per_epoch):
                    idx = _order[s * B:(s + 1) * B]
                    nreal = len(idx)
                    if nreal < B:
                        idx = np.concatenate(
                            [idx, np.repeat(idx[-1:], B - nreal)])
                    for k in range(accum):
                        yield (s * accum + k,
                               (s, k, nreal, idx[k * micro:(k + 1) * micro]))

        def assemble(pl, _ep=ep):
            s, k, nreal, rows = pl
            if streaming:
                enc = tok.encode_batch(rows, max_len=max_len)
                ids_s = np.asarray(enc["input_ids"], np.int32)
                attn_s = np.asarray(enc["attention_mask"], np.int32)
            else:
                ids_s, attn_s = ids[rows], attn[rows]
            row0 = k * micro
            masked, sel = _mask_rows(
                ids_s, attn_s, mask_id, tok.vocab_size,
                (seed, _ep, s + 1), B, row0, mask_prob)
            # pad rows (global position >= nreal) train with the selection
            # cleared: exactly zero loss and gradient
            pos = np.arange(row0, row0 + ids_s.shape[0])
            sel = sel & (pos < nreal)[:, None]
            return place([masked, attn_s, ids_s, sel])

        if feed == "sync":
            it = ((m, assemble(pl)) for m, pl in payloads())
        else:
            it = stream_map(lambda *devs: list(devs),
                            ((m, (pl,)) for m, pl in payloads()),
                            put=lambda args: assemble(args[0]), device=dev)

        ep_losses: List[torch.Tensor] = []
        with trace_span("train.epoch", epoch=ep, rank=0, shards=1):
            t_step = time.perf_counter()
            for m, devs in _timed_feed(it):
                s, k = divmod(m, accum)
                micro_step(acc, {"input_ids": devs[0],
                                 "attention_mask": devs[1]},
                           devs[2], devs[3])
                metrics.incr("train.micro_steps")
                if k < accum - 1:
                    continue
                t_f = time.perf_counter()
                ep_losses.append(apply_step(acc))
                now = time.perf_counter()
                metrics.observe("train.accum_flush_s", now - t_f)
                metrics.observe("train.step_s", now - t_step)
                t_step = now
                step += 1
                metrics.incr("train.steps")
                metrics.incr("train.rows",
                             int(min(B, n - s * B)) if n >= B else B)
                if ckpt is not None and checkpoint_every and \
                        step % checkpoint_every == 0 and \
                        s + 1 < steps_per_epoch:
                    ckpt.save(step, _host_state(model), opt.state_dict(),
                              {"epoch": ep - 1, "mid_epoch": ep,
                               "next_batch": s + 1, "step": step})
            history.append(_epoch_loss(ep_losses))
        if ckpt is not None:
            ckpt.save(step, _host_state(model), opt.state_dict(),
                      {"epoch": ep, "step": step})
    return history


def pretrain_and_save(texts, out_dir: str, **kw) -> dict:
    """Pretrain and write the HF-layout checkpoint directory that the BERT
    ops read through ``checkpointFilePath`` (``texts`` as in
    :func:`pretrain_mlm`, which takes ``kw``). Returns a summary dict."""
    from .pretrained import save_bert_checkpoint

    cfg, params, tok, history = pretrain_mlm(texts, **kw)
    save_bert_checkpoint(params, cfg, out_dir, tok.to_list())
    return {
        "path": out_dir,
        "vocab_size": tok.vocab_size,
        "initial_loss": round(history[0], 4) if history else None,
        "final_loss": round(history[-1], 4) if history else None,
        "epochs": len(history),
    }
