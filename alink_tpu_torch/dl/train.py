"""The DL train loop and batched inference (port of ``alink_tpu/dl/train.py``).

Training keeps the reference's contract step for step:

- :class:`TrainConfig` has every field of the reference's;
- :func:`make_optimizer` is optax's ``adamw``, ``adam`` or
  ``sgd(momentum=0.9)`` under ``warmup_cosine_decay_schedule(0, lr, warmup,
  max(total, warmup + 1))``, written in torch (``torch._foreach_*`` over all
  parameters): the first update runs at lr 0, adamw's weight decay is
  decoupled and covers every parameter, Adam's bias correction is optax's;
- :func:`loss_fn` gives ``softmax``, ``mse`` and ``gaussian_nll``, plain,
  weighted (``sum(l·w) / max(sum(w), 1)``) and ``"sum"``;
- :func:`make_train_step` is one step: forward, weighted loss, backward,
  update; :func:`make_accum_programs` the ordered-chunk accumulation, whose
  ``micro`` and ``fused`` schedules add the same fp32 chunk gradients in
  the same order and divide once, so they are bit-identical;
- :func:`train_model` splits and shuffles rows with the reference's numpy
  generators (``default_rng(seed)`` for the eval split, ``default_rng((seed,
  epoch))`` for each epoch's order), so both packages feed the same rows in
  the same order; the ragged tail is padded with zero-weight rows (exact),
  and it keeps eval, early stopping on a host copy of the best parameters,
  the history and checkpoint/resume (:mod:`.checkpoint`).

Dropout draws come from a ``torch.Generator`` seeded from (seed, step) (and
the chunk under accumulation) on the model's device, where the reference
folds the step into its key: the draws differ from JAX's by design. Eager
PyTorch needs no program cache, no donation and no shape buckets. One
process only: data parallelism over processes is the distributed slice
(ROADMAP A3).

Model state that is not a parameter (a BatchNorm's running statistics, the
reference's ``batch_stats`` collection) lives in the model's buffers: the
training-mode forward updates it, the optimizer never sees it, and it is
saved, restored and returned with the parameters. Accumulation over chunks
refuses such state, as the reference does.

Inference (:func:`predict_model`) feeds rows in chunks of ``batch_size`` as
they come, under the serving precision policy (:mod:`..common.quant`):
``bf16`` rounds every float state entry through bf16; ``int8`` quantizes the
reference's variables tree (:func:`~..common.quant.quantize_tree`: one scale
per last flax axis of every leaf of two or more dimensions) and keeps the
int8 tensors and their scales as the served state on the device, dequantized
inside each forward (``q.float() * s``) as the reference's program does.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.env import resolve_device
from ..common.metrics import metrics
from ..common.tracing import trace_span
from ..common.exceptions import (AkIllegalArgumentException,
                                 AkUnsupportedOperationException)
from ..common import quant


@dataclass
class TrainConfig:
    num_epochs: int = 3
    batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    warmup_ratio: float = 0.1
    optimizer: str = "adamw"  # adamw | adam | sgd
    early_stopping_patience: int = 0  # 0 = off
    eval_ratio: float = 0.0  # fraction of rows held out for eval
    seed: int = 0
    loss: str = "auto"  # auto | softmax | mse | gaussian_nll
    log_every: int = 0
    # mid-training checkpoint/resume (dl/checkpoint.py); None disables
    checkpoint_dir: "str | None" = None
    checkpoint_every: int = 0  # extra mid-epoch saves every N steps; 0 = only per epoch
    resume: bool = True
    # input pipeline: "async" assembles (and on the card, pins and ships)
    # batches on a thread ahead of compute; "sync" inline. Same batches.
    feed: str = "async"
    feed_depth: int = 0  # batches in flight ahead of compute; 0 = 2
    # gradient accumulation: the step's gradient is the ORDERED fp32 sum of
    # accum_steps chunk gradients over the effective batch (batch_size
    # rows, divisible by accum_steps), divided once. "micro" runs one chunk
    # a call, "fused" all chunks in one call; bit-identical.
    accum_steps: int = 1
    accum_mode: str = "micro"  # micro | fused
    # checkpoint retention: keep the last K checkpoints on disk (None =
    # the ALINK_CKPT_KEEP env knob, default 3; <= 0 = unbounded)
    checkpoint_keep: "int | None" = None


# ---------------------------------------------------------------------------
# optimizer and schedule (optax's, step for step)
# ---------------------------------------------------------------------------


def warmup_cosine_schedule(peak: float, warmup: int,
                           decay_steps: int) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(0.0, peak, warmup, decay_steps)``
    in fp32: linear from 0 over ``warmup`` steps, then cosine to 0 over
    ``decay_steps - warmup``. Step counts start at 0."""
    f32 = np.float32
    peak_f = f32(peak)

    def sched(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(count) / f32(warmup)
            return float((f32(0) - peak_f) * frac + peak_f)
        t = f32(min(count - warmup, decay_steps - warmup))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t
                                          / f32(decay_steps - warmup)))
        return float(peak_f * cos)

    return sched


class Optimizer:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay
    on every parameter), ``adam`` or ``sgd(momentum=0.9)`` under a schedule,
    over named parameters updated in place. The update at step t (from 0)
    runs at ``schedule(t)``."""

    B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9

    def __init__(self, kind: str, schedule: Callable[[int], float],
                 params: Dict[str, torch.Tensor], weight_decay: float = 0.0):
        if kind not in ("adamw", "adam", "sgd"):
            raise AkIllegalArgumentException(f"unknown optimizer {kind!r}")
        self.kind, self.schedule = kind, schedule
        self.weight_decay = weight_decay if kind == "adamw" else 0.0
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.slots: Dict[str, List[torch.Tensor]] = (
            {"trace": zeros()} if kind == "sgd" else
            {"mu": zeros(), "nu": zeros()})

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        lr = self.schedule(self.count)
        if self.kind == "sgd":
            tr = self.slots["trace"]
            torch._foreach_mul_(tr, self.MOMENTUM)
            torch._foreach_add_(tr, grads)
            torch._foreach_add_(self.params, tr, alpha=-lr)
        else:
            mu, nu = self.slots["mu"], self.slots["nu"]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.B2)
            t = self.count + 1
            bc1 = float(np.float32(1) - np.float32(self.B1) ** t)
            bc2 = float(np.float32(1) - np.float32(self.B2) ** t)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if self.weight_decay:
                torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
            torch._foreach_add_(self.params, upd, alpha=-lr)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """Host copies: ``count`` and each slot by parameter name."""
        return {"count": self.count, **{
            k: {n: t.detach().cpu().clone() for n, t in zip(self.names, v)}
            for k, v in self.slots.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for k, v in self.slots.items():
            for n, t in zip(self.names, v):
                t.copy_(state[k][n])


def make_optimizer(cfg: TrainConfig, total_steps: int,
                   params: Dict[str, torch.Tensor]) -> Optimizer:
    """The reference's ``_make_optimizer`` over ``params`` (name → tensor)."""
    warmup = max(1, int(total_steps * cfg.warmup_ratio))
    sched = warmup_cosine_schedule(cfg.learning_rate, warmup,
                                   max(total_steps, warmup + 1))
    return Optimizer(cfg.optimizer, sched, params, cfg.weight_decay)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def loss_fn(kind: str, regression: bool, weighted: "bool | str" = False):
    """Scalar loss ``f(logits, y)``; with ``weighted=True`` the masked form
    ``f(logits, y, w) = sum(l_i·w_i) / max(sum(w), 1)`` (zero-weight rows add
    nothing); with ``weighted="sum"`` the unnormalised ``sum(l_i·w_i)`` that
    the accumulation chunks differentiate."""
    if kind == "auto":
        kind = "mse" if regression else "softmax"
    if kind == "softmax":
        def per_row(logits, y):
            return F.cross_entropy(logits.float(), y.long(), reduction="none")
    elif kind == "mse":
        def per_row(logits, y):
            y = y.float()
            if logits.dim() == y.dim() + 1 and logits.shape[-1] == 1:
                logits = logits.squeeze(-1)
            d = (logits.float() - y) ** 2
            return d if d.dim() == 1 else d.mean(-1)
    elif kind == "gaussian_nll":
        def per_row(logits, y):
            mu, log_sigma = logits[..., 0].float(), logits[..., 1].float()
            sigma2 = torch.exp(2.0 * log_sigma)
            return log_sigma + 0.5 * (y.float() - mu) ** 2 / sigma2
    else:
        raise AkIllegalArgumentException(f"unknown loss {kind!r}")

    if not weighted:
        return lambda logits, y: per_row(logits, y).mean()
    if weighted == "sum":
        return lambda logits, y, w: (per_row(logits, y) * w.float()).sum()

    def fw(logits, y, w):
        w = w.float()
        return (per_row(logits, y) * w).sum() / torch.clamp(w.sum(), min=1.0)
    return fw


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def dropout_generator(seed: int, step: int, device, *chunk: int
                      ) -> torch.Generator:
    """The dropout generator of one step (and chunk) on ``device``, seeded
    from (seed, step, chunk...)."""
    key = np.random.SeedSequence([int(seed), int(step), *map(int, chunk)])
    return torch.Generator(device=device).manual_seed(
        int(key.generate_state(1, np.uint64)[0] >> 1))


def _trainable(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _chunk_grad(model, params, loss_of, batch, y, w, rng):
    logits = model(**batch, deterministic=rng is None, rng=rng)
    loss = loss_of(logits, y, w) if w is not None else loss_of(logits, y)
    # a parameter the batch does not reach (type_emb without token types)
    # gets a zero gradient
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g
                  for p, g in zip(params, grads)]


def make_train_step(model, opt: Optimizer, loss_of, *, weighted: bool = False):
    """One optimizer step: ``step(batch, y, w=None, rng=None) -> loss`` (a
    0-dim device tensor). ``batch`` maps the model's keyword arguments to
    tensors; ``w`` the rows' loss weights when ``weighted``; ``rng`` the
    step's dropout generator (None: deterministic)."""
    params = opt.params

    def step(batch, y, w=None, rng=None):
        loss, grads = _chunk_grad(model, params, loss_of, batch, y,
                                  w if weighted else None, rng)
        opt.step(grads)
        return loss.detach()

    return step


def make_accum_programs(model, opt: Optimizer, loss_sum_of, accum: int):
    """The ordered-chunk gradient schedule: ``(micro_step, apply_step,
    fused_step)``.

    - ``micro_step(acc, batch, y, w, rng)`` adds one chunk's gradient of
      ``loss_sum_of`` (the unnormalised ``sum(l·w)``), its weight and loss
      into the fp32 accumulators ``acc = (grads, wsum, lsum)``
      (:func:`new_accumulators` over the optimizer's parameters);
    - ``apply_step(acc)`` divides by ``max(wsum, 1)``, steps the optimizer,
      zeroes the accumulators and returns the step's loss;
    - ``fused_step(batch, y, w, rngs)`` runs the same chunk body over
      (accum, micro, ...) stacks in one call, then the same apply.

    Both schedules add the same values in the same order."""
    params = opt.params

    def micro_step(acc, batch, y, w, rng=None):
        gacc, wacc, lacc = acc
        lsum, g = _chunk_grad(model, params, loss_sum_of, batch, y, w, rng)
        torch._foreach_add_(gacc, [x.float() for x in g])
        wacc.add_(w.float().sum())
        lacc.add_(lsum.detach())
        return acc

    def apply_step(acc):
        gacc, wacc, lacc = acc
        denom = torch.clamp(wacc, min=1.0)
        opt.step([g / denom for g in gacc])
        loss = lacc / denom
        torch._foreach_zero_(gacc)
        wacc.zero_()
        lacc.zero_()
        return loss

    def fused_step(batch, y, w, rngs=None):
        acc = new_accumulators(params)
        for k in range(accum):
            micro_step(acc, {n: t[k] for n, t in batch.items()}, y[k], w[k],
                       None if rngs is None else rngs[k])
        return apply_step(acc)

    return micro_step, apply_step, fused_step


def new_accumulators(params: Sequence[torch.Tensor]):
    """Zeroed fp32 accumulators ``(grads, wsum, lsum)`` for ``params``."""
    dev = params[0].device
    return ([torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for p in params],
            torch.zeros((), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


def _feed(build: Callable[[int], Sequence[np.ndarray]],
          place: Callable[[Sequence[np.ndarray]], List[torch.Tensor]],
          steps: int, *, mode: str = "async", depth: int = 0,
          phases: Optional[dict] = None, device=None
          ) -> Iterator[Tuple[int, List[torch.Tensor]]]:
    """Yield ``(step, tensors)`` for ``place(build(step))``. ``async`` runs
    both on :func:`~alink_tpu_torch.common.streaming.stream_map`'s transfer
    thread (its ``put``), up to ``depth`` (default ``ALINK_STREAM_DEPTH``, 2)
    batches ahead of compute, accumulating its ``phases``; ``sync`` inline.
    Both call the same functions in the same step order."""
    if mode not in ("async", "sync"):
        raise AkIllegalArgumentException(f"unknown feed mode {mode!r}")
    if mode == "sync":
        for s in range(steps):
            yield s, place(build(s))
        return
    from ..common.streaming import stream_map

    def put(args):
        # the "host arrays" slot carries only the step number: the batch is
        # assembled inside put, on the transfer thread
        return place(build(int(args[0])))

    yield from stream_map(lambda *devs: list(devs),
                          ((s, (s,)) for s in range(steps)), put=put,
                          depth=depth or None, phases=phases, device=device)


def _placer(dev: torch.device):
    """Host arrays → tensors on ``dev`` (pinned and copied non-blocking on
    the card)."""
    pinned = dev.type == "cuda"

    def place(arrs):
        out = []
        for a in arrs:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pinned:
                t = t.pin_memory().to(dev, non_blocking=True)
            out.append(t)
        return out
    return place


def _timed_feed(it):
    """Drain a feed iterator, observing ``train.feed_wait_s``: the time the
    step loop blocked waiting for the next device batch (~0 when the async
    feed overlaps; ~assembly + transfer when the host is the bottleneck).
    ``train.step_s`` stays with the callers: its unit is the optimizer
    step, which under accumulation spans several feed items."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        metrics.observe("train.feed_wait_s", time.perf_counter() - t0)
        yield item


def _pad_tail(arrs: List[np.ndarray], target: int) -> List[np.ndarray]:
    """Pad row-aligned arrays to ``target`` rows by repeating the last real
    row: numerically safe for any model (no all-padding attention rows, no
    degenerate inputs), and exact under a zero loss weight."""
    m = arrs[0].shape[0]
    if m == target:
        return arrs
    return [np.concatenate([a, np.repeat(a[-1:], target - m, axis=0)])
            for a in arrs]


def _check_single_process(what: str = "train_model") -> None:
    multi = int(os.environ.get("NUM_PROCESSES", "1") or 1) > 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        multi = multi or torch.distributed.get_world_size() > 1
    if multi:
        raise AkUnsupportedOperationException(
            f"{what} runs in one process: multi-process data parallelism "
            "is not ported yet (ROADMAP A3)")


def _host_state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def train_model(model, inputs: Dict[str, np.ndarray], y: np.ndarray,
                cfg: TrainConfig, *, regression: bool = False,
                init_params=None, device=None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Train ``model`` (called as ``model(**batch, deterministic=...,
    rng=...)``) on ``inputs`` (name → (n, ...) arrays) and targets ``y``.

    Parameters start from ``init_params`` (the reference's flax tree,
    carried over by :func:`~alink_tpu_torch.dl.convert.flax_to_torch`),
    else from ``model.init_weights(cfg.seed)``. Runs on
    ``device`` (see :func:`~alink_tpu_torch.common.env.resolve_device`).
    Returns the final (or, with eval, the best) parameters as a host state
    dict, also loaded into ``model``, and the history: ``loss`` (per epoch,
    or every ``log_every`` steps), ``eval_metric`` (accuracy, or −MSE for
    regression) and ``final_loss``."""
    _check_single_process()
    accum = int(cfg.accum_steps or 1)
    if accum < 1:
        raise AkIllegalArgumentException(
            f"accum_steps must be >= 1, got {cfg.accum_steps}")
    if cfg.accum_mode not in ("micro", "fused"):
        raise AkIllegalArgumentException(
            f"unknown accum_mode {cfg.accum_mode!r}")
    if accum > 1 and cfg.batch_size % accum:
        raise AkIllegalArgumentException(
            f"batch_size={cfg.batch_size} is not divisible by "
            f"accum_steps={accum}: micro chunks must tile the effective "
            "batch exactly (the ordered-chunk gradient contract)")
    dev = resolve_device(device)
    model.to(dev)

    n = y.shape[0]
    rng = np.random.default_rng(cfg.seed)
    n_eval = int(n * cfg.eval_ratio)
    perm = rng.permutation(n)
    eval_idx, train_idx = perm[:n_eval], perm[n_eval:]
    tr_inputs = {k: v[train_idx] for k, v in inputs.items()}
    tr_y = y[train_idx]
    ev_inputs = {k: v[eval_idx] for k, v in inputs.items()}
    ev_y = y[eval_idx]
    n_train = tr_y.shape[0]

    bs = max(accum, (min(cfg.batch_size, n_train) // accum) * accum)
    steps_per_epoch = -(-n_train // bs) if n_train >= bs else 1
    total_steps = steps_per_epoch * cfg.num_epochs

    if init_params is None:
        model.init_weights(cfg.seed)
    else:
        from .convert import from_flax

        model.load_state_dict(from_flax(model, init_params))
    params = _trainable(model)
    if accum > 1 and any(True for _ in model.buffers()):
        raise AkIllegalArgumentException(
            "accum_steps supports params-only models: non-parameter state "
            "(e.g. BatchNorm's running statistics) has no well-defined "
            "cross-chunk accumulation order")
    opt = make_optimizer(cfg, total_steps, params)
    if accum > 1:
        micro_prog, apply_prog, fused_prog = make_accum_programs(
            model, opt, loss_fn(cfg.loss, regression, weighted="sum"), accum)
    else:
        train_step = make_train_step(
            model, opt, loss_fn(cfg.loss, regression, weighted=True),
            weighted=True)

    ckpt = None
    start_epoch, step = 0, 0
    history: Dict[str, Any] = {"loss": [], "eval_metric": []}
    best_metric, best_params = None, None
    patience_left = cfg.early_stopping_patience
    if cfg.checkpoint_dir:
        from .checkpoint import TrainCheckpointManager

        ckpt = TrainCheckpointManager(cfg.checkpoint_dir,
                                      max_to_keep=cfg.checkpoint_keep)
        if cfg.resume:
            restored = ckpt.restore_latest()
            if restored is not None:
                r_params, r_opt, extra = restored
                model.load_state_dict(r_params)
                opt.load_state_dict(r_opt)
                step = int(extra.get("step", 0))
                start_epoch = int(extra.get("epoch", -1)) + 1

    names = sorted(tr_inputs)
    place = _placer(dev)

    micro_rows = bs // accum
    acc = new_accumulators(opt.params) \
        if accum > 1 and cfg.accum_mode == "micro" else None
    feed_phases: Dict[str, Any] = {}
    feed_kw = dict(mode=cfg.feed, depth=cfg.feed_depth, phases=feed_phases,
                   device=dev)
    t_start = time.perf_counter()
    start_step = step   # resume restores the counter; the rate uses deltas

    def after_step(s, loss, epoch):
        nonlocal step
        step += 1
        metrics.incr("train.steps")
        metrics.incr("train.rows", int(min(bs, n_train - s * bs))
                     if n_train >= bs else bs)
        if ckpt is not None and cfg.checkpoint_every \
                and step % cfg.checkpoint_every == 0:
            # mid-epoch save: resume restarts this epoch with this state
            ckpt.save(step, _host_state(model), opt.state_dict(),
                      {"step": step, "epoch": epoch - 1})
        if cfg.log_every and step % cfg.log_every == 0:
            log_loss(float(loss))

    def log_loss(lv):
        history["loss"].append(lv)
        elapsed = time.perf_counter() - t_start
        metrics.record("dl.train", step=step, loss=lv,
                       samples_per_sec=(step - start_step) * bs
                       / max(elapsed, 1e-9))

    def full_batch(order, s):
        idx = order[s * bs:(s + 1) * bs]
        arrs = [tr_inputs[k][idx] for k in names] + [tr_y[idx]]
        w = np.ones(len(idx), np.float32)
        if len(idx) < bs:
            arrs = _pad_tail(arrs, bs)
            w = np.concatenate([w, np.zeros(bs - len(idx), np.float32)])
        return arrs + [w]

    def timed_step(run):
        # host wall from one step's issue to the next: no sync per step
        nonlocal t_step
        out = run()
        now = time.perf_counter()
        metrics.observe("train.step_s", now - t_step)
        t_step = now
        return out

    loss = None
    for epoch in range(start_epoch, cfg.num_epochs):
        with trace_span("train.epoch", epoch=epoch, rank=0, shards=1):
            # per-(seed, epoch) generator: a resumed run replays the shuffle
            order = np.random.default_rng((cfg.seed, epoch)).permutation(
                n_train)
            if n_train < bs:  # tile tiny datasets up to one full batch
                order = np.resize(order, bs)

            t_step = time.perf_counter()
            if accum == 1:
                for s, devs in _timed_feed(_feed(
                        lambda s, o=order: full_batch(o, s), place,
                        steps_per_epoch, **feed_kw)):
                    batch = dict(zip(names, devs[:-2]))
                    loss = timed_step(lambda: train_step(
                        batch, devs[-2], devs[-1],
                        dropout_generator(cfg.seed, step, dev)))
                    after_step(s, loss, epoch)
            elif cfg.accum_mode == "fused":
                def build_fused(s, o=order):
                    return [a.reshape((accum, micro_rows) + a.shape[1:])
                            for a in full_batch(o, s)]

                for s, devs in _timed_feed(_feed(
                        build_fused, place, steps_per_epoch, **feed_kw)):
                    batch = dict(zip(names, devs[:-2]))
                    rngs = [dropout_generator(cfg.seed, step, dev, k)
                            for k in range(accum)]
                    loss = timed_step(lambda: fused_prog(
                        batch, devs[-2], devs[-1], rngs))
                    after_step(s, loss, epoch)
            else:
                def build_micro(m, o=order):
                    s, k = divmod(m, accum)
                    start = s * bs
                    m_real = min(bs, len(o) - start)
                    pos = np.arange(k * micro_rows, (k + 1) * micro_rows)
                    # positions past the real rows repeat the effective
                    # batch's last real row with zero loss weight
                    idx = o[start + np.minimum(pos, m_real - 1)]
                    arrs = [tr_inputs[k2][idx] for k2 in names] + [tr_y[idx]]
                    return arrs + [(pos < m_real).astype(np.float32)]

                for m, devs in _timed_feed(_feed(
                        build_micro, place, steps_per_epoch * accum,
                        **feed_kw)):
                    s, k = divmod(m, accum)
                    batch = dict(zip(names, devs[:-2]))
                    micro_prog(acc, batch, devs[-2], devs[-1],
                               dropout_generator(cfg.seed, step, dev, k))
                    metrics.incr("train.micro_steps")
                    if k == accum - 1:
                        t_f = time.perf_counter()
                        loss = timed_step(lambda: apply_prog(acc))
                        metrics.observe("train.accum_flush_s",
                                        time.perf_counter() - t_f)
                        after_step(s, loss, epoch)
            if not cfg.log_every:
                log_loss(float(loss))

            if ckpt is not None:
                ckpt.save(step, _host_state(model), opt.state_dict(),
                          {"step": step, "epoch": epoch})
            if n_eval:
                logits = _batched_apply(model, ev_inputs, bs, dev)
                if regression:
                    metric = -float(np.mean((logits.squeeze(-1) - ev_y)
                                            ** 2))
                else:
                    metric = float(np.mean(np.argmax(logits, -1) == ev_y))
                history["eval_metric"].append(metric)
                if best_metric is None or metric > best_metric:
                    best_metric, best_params = metric, _host_state(model)
                    patience_left = cfg.early_stopping_patience
                elif cfg.early_stopping_patience:
                    patience_left -= 1
                    if patience_left <= 0:
                        break

    if best_params is not None:
        model.load_state_dict(best_params)
    history["final_loss"] = history["loss"][-1] if history["loss"] else None
    if feed_phases:
        # compute runs in this loop (the feed's function is the identity),
        # so only the transfer side carries signal here
        history["feed"] = {
            "mode": cfg.feed,
            "transfer_s": round(feed_phases.get("transfer_s", 0.0), 4),
            "batches": feed_phases.get("batches", 0),
        }
    return _host_state(model), history


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


def _batched_apply(model, inputs: Dict[str, np.ndarray], bs: int,
                   device, served=None,
                   kernel_id: str = "dl.apply_logits",
                   **forward_kw) -> np.ndarray:
    """Logits of ``model`` over ``inputs`` in chunks of ``bs`` rows; with
    ``served`` (:func:`served_state`) each chunk's forward runs on that
    state, int8 entries dequantized in it.

    Each chunk is padded up the bucket ladder (``bucket_rows``) with its
    last row repeated and trimmed after, as the reference's is: the forward
    is row-wise, so the real rows are the unpadded run's, and every request
    size meets one of a few batch shapes (each recorded under
    ``kernel_id``, see ``common/jitcache.note_signature``)."""
    from ..common.jitcache import bucket_rows, bucketing_enabled, \
        note_signature

    names = sorted(inputs)
    n = inputs[names[0]].shape[0]
    outs = []
    with torch.inference_mode():
        for s in range(0, n, bs):
            chunk = [np.asarray(inputs[k][s:s + bs]) for k in names]
            m = chunk[0].shape[0]
            target = bucket_rows(m) if bucketing_enabled() else m
            chunk = _pad_tail(chunk, target)
            note_signature(kernel_id, chunk)
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in zip(names, chunk)}
            if served is None:
                out = model(**batch, **forward_kw)
            else:
                state = {k: q if sc is None else q.float() * sc
                         for k, (q, sc) in served.items()}
                out = torch.func.functional_call(model, state, (),
                                                 {**batch, **forward_kw})
            outs.append(out.float()[:m].cpu().numpy())
    return np.concatenate(outs, axis=0)


def _int8_state(model) -> Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The reference's ``quantize_tree`` over ``model``'s variables tree,
    carried back to the state dict's layout: int8 tensors with fp32 scales
    shaped to broadcast against them (along the axes the carry moved the
    flax last axis to), the other entries as they are with scale None."""
    from .convert import from_flax, to_flax

    variables = to_flax(model)
    q_tree, s_tree = quant.quantize_tree(variables)

    def expand(s, leaf):
        if isinstance(s, dict):
            return {k: expand(s[k], leaf[k]) for k in s}
        if s is None:
            return np.zeros(np.shape(leaf), np.float32)
        return np.broadcast_to(s, np.shape(leaf)).copy()

    q_state = from_flax(model, q_tree)
    s_state = from_flax(model, expand(s_tree, variables))
    dev = next(iter(model.state_dict().values())).device
    out = {}
    for name, q in q_state.items():
        sc = None
        if q.dtype == torch.int8:
            sc = s_state[name]
            for ax in range(sc.dim()):   # keep one entry along equal axes
                if bool((sc == sc.narrow(ax, 0, 1)).all()):
                    sc = sc.narrow(ax, 0, 1)
            sc = sc.contiguous().to(dev)
        out[name] = (q.to(dev), sc)
    return out


def served_state(model, policy: Optional[str]):
    """The state ``model`` serves under ``policy`` (None: its own, and this
    returns None): ``{name: (tensor, scale or None)}`` on the model's
    device. bf16 rounds every float entry through bf16; int8 is
    :func:`_int8_state`. Built once per policy and kept on the model, one
    per policy, until its state changes (tensor versions and storage); each
    build counts in ``dl.served_state_builds``."""
    if policy is None:
        return None
    sd = model.state_dict()
    key = tuple((t.data_ptr(), t._version) for t in sd.values())
    if not hasattr(model, "_served_states"):
        model._served_states = {}
    cached = model._served_states.get(policy)
    if cached is not None and cached[0] == key:
        return cached[1]
    metrics.incr("dl.served_state_builds")
    if policy == quant.BF16:
        state = {k: (t.to(torch.bfloat16).to(t.dtype)
                     if t.is_floating_point() else t, None)
                 for k, t in sd.items()}
    elif policy == quant.INT8:
        state = _int8_state(model)
    else:
        raise AkIllegalArgumentException(f"unknown policy {policy!r}")
    model._served_states[policy] = (key, state)
    return state


def predict_model(model: torch.nn.Module, inputs: Dict[str, np.ndarray], *,
                  batch_size: int = 256, device=None,
                  precision: Optional[str] = None,
                  return_pooled: bool = False) -> np.ndarray:
    """Batched inference returning fp32 logits ``(n, out_dim)``.

    ``model`` is moved to ``device`` (default: see
    :func:`~alink_tpu_torch.common.env.resolve_device`) and run in eval mode
    over ``inputs`` (name → ``(n, ...)`` array, the model's keyword
    arguments) in chunks of ``batch_size`` rows, under the serving
    ``precision`` policy (None/"fp32", "bf16", "int8"; see
    :func:`served_state`). ``return_pooled`` returns the pooled states the
    head reads instead (``(n, hidden)``, BERT embedding serving)."""
    policy = quant.resolve_policy(precision)
    dev = resolve_device(device)
    model = model.to(dev).eval()
    kernel_id = "dl.apply_pooled" if return_pooled else "dl.apply_logits"
    extra = {"return_pooled": True} if return_pooled else {}
    return _batched_apply(model, inputs, batch_size, dev,
                          served_state(model, policy),
                          kernel_id=kernel_id + ("." + policy if policy
                                                 else ""), **extra)
