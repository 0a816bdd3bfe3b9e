"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--steps N] [--device cuda|cpu]``.

The port of ``python -m repro.launch.train``: trains a (reduced by
default) architecture on the synthetic QA corpus with AdamW and the
warmup-cosine schedule, logs the loss, and writes a checkpoint at the end.
``--full`` takes the published config (bf16 weights, f32 moments);
``--n-layers N`` cuts its depth, as ``launch.serve`` does. ``--device``
defaults to ``cuda`` and fails without it; on the card the attention's
forward and backward run in the hand-written flash-attention kernels.

The batches are the reference's: ``make_batches`` is its numpy sampler
over the same tokenizer and corpus, so the token rows are equal. Weights
are drawn from ``prng.key(0)`` on the device, equal to the reference's
``init_params(PRNGKey(0))`` within 1e-5 relative on any device (``prng``),
unless ``train`` gets ``params=``, e.g. ``convert.params_from_jax`` of the
reference's. Like the reference, it
feeds (B, L) text tokens, which the audio family (B, L, C codebook
tokens) cannot take: it raises a ValueError there, and audio trains
through ``Model.loss_fn`` directly.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.types import resolve_device
from repro_torch.data.qa_dataset import build_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, init_adamw,
                                            make_train_step)


def make_batches(tokenizer, pairs, batch: int, seq: int, vocab: int, seed=0):
    """Pack Q+A text into fixed-length LM training rows: (batch, seq)
    int32 numpy arrays, drawn as the reference draws them."""
    texts = [f"{p.question} ? {p.answer}" for p in pairs]
    toks, _ = tokenizer.encode_batch(texts, seq)
    toks = np.minimum(toks, vocab - 1)
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(texts), size=batch)
        yield toks[idx]


def train(arch: str = "deepseek-7b", *, steps: int = 200, batch: int = 8,
          seq: int = 128, lr: float = 3e-3, full: bool = False,
          n_layers: int | None = None, checkpoint: str | None = None,
          log_every: int = 10, device: str = "cuda",
          params: dict[str, torch.Tensor] | None = None, log=print) -> dict:
    """Train; returns the model and the per-step losses, learning
    rates and gradient norms (host floats). ``params`` (a state dict, e.g.
    ``convert.params_from_jax``) replaces the random init."""
    config = get_arch(arch)
    if not full:
        config = config.reduced()
    if n_layers is not None:
        config = dataclasses.replace(config, n_layers=n_layers)
    if config.n_codebooks > 1:
        raise ValueError(
            f"{config.name}: the training driver feeds (B, L) text tokens, "
            f"and the audio family takes (B, L, {config.n_codebooks}) "
            "codebook tokens; train it through Model.loss_fn (the reference's "
            "training driver fails here too)")
    device = resolve_device(device)
    model = Model(config, device=device)
    if params is None:
        model.init_params(prng.key(0))
    else:
        model.load_state_dict(params)
    model.requires_grad_(True)
    tokenizer = HashTokenizer(vocab_size=config.vocab)
    named = dict(model.named_parameters())
    opt = init_adamw(named)
    ocfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                       total_steps=steps)
    n_params = sum(p.numel() for p in named.values())
    log(f"arch={config.name} params={n_params/1e6:.1f}M "
        f"steps={steps} batch={batch} seq={seq}")

    step = make_train_step(
        lambda _params, tokens: model.loss_fn(tokens, remat=True), ocfg)
    batches = make_batches(tokenizer, build_corpus(500), batch, seq,
                           config.vocab)
    history = {"loss": [], "lr": [], "grad_norm": []}
    t0 = time.time()
    for i in range(steps):
        tokens = torch.as_tensor(next(batches), dtype=torch.long,
                                 device=device)
        named, opt, metrics = step(named, opt, tokens)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        history["loss"].append(loss)
        history["lr"].append(metrics["lr"])
        history["grad_norm"].append(gnorm)
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:5d} loss {loss:.4f} lr {metrics['lr']:.2e} "
                f"gnorm {gnorm:.2f} ({(time.time()-t0)/(i+1):.2f}s/step)")
    if checkpoint:
        save_checkpoint(checkpoint, params_to_numpy(named),
                        metadata={"arch": config.name, "steps": steps})
        log(f"checkpoint -> {checkpoint}")
    return {"model": model, **history}


def params_to_numpy(named: dict[str, torch.Tensor], prefix: str = "params"
                    ) -> dict[str, np.ndarray]:
    """The reference's checkpoint keys for ``{"params": tree}``
    (``params/blocks/wq``), bfloat16 written as float32."""
    return {f"{prefix}/{name.replace('.', '/')}":
            p.detach().to(torch.float32).cpu().numpy()
            if p.dtype == torch.bfloat16 else p.detach().cpu().numpy()
            for name, p in named.items()}


def main(argv=None) -> dict:
    """The command line over ``train``; returns its result (the model and
    the per-step losses, learning rates and gradient norms)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full-size config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return train(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, lr=args.lr, full=args.full,
                 n_layers=args.n_layers, checkpoint=args.checkpoint,
                 log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
