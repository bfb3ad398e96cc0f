"""A ``transformers.Trainer``-shaped front end over the port's Trainer
(the port of torchacc_tpu/train/hf_trainer.py ``HFTrainerAdapter``).

An HF training script swaps

    trainer = transformers.Trainer(model=model, args=args, ...)
for
    trainer = torchacc_tpu_torch.HFTrainerAdapter(model=model, args=args,
                                                  config=tt.Config(...))

and keeps its dataset, collator and arguments.  ``accelerate`` converts
the HF model once (``models.hf.load_hf_model``) into the port's
``Trainer``, which trains it.  ``TrainingArguments`` is read by
attribute, so ``transformers`` is not imported.

Mapped arguments: per_device_train_batch_size (times the mesh's data
extent), learning_rate, weight_decay, adam betas and epsilon,
max_grad_norm, warmup_steps/warmup_ratio, lr_scheduler_type
(linear|cosine|constant), gradient_accumulation_steps, max_steps /
num_train_epochs, logging_steps, save_steps, output_dir, bf16/fp16,
seed.  Everything else is accepted and ignored (logged once).  The
training batches drop a ragged last batch (the JAX package's default
``data.drop_last``); evaluation keeps it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.utils.logger import logger


def _batch(batch) -> Dict[str, Any]:
    # causal masking and -100 labels stand for attention_mask: the
    # model takes (input_ids, positions, segment_ids, labels)
    out = dict(batch)
    out.pop("attention_mask", None)
    return out


class HFTrainerAdapter:
    """``transformers.Trainer``'s surface (``train``, ``evaluate``,
    ``save_model``, ``state``) over the port's Trainer; ``device``: where
    the model is made (None = the card)."""

    def __init__(self, model=None, args=None, train_dataset=None,
                 eval_dataset=None, data_collator=None, tokenizer=None,
                 config: Optional[Config] = None, optimizer=None, *,
                 device=None, **ignored):
        if model is None or args is None:
            raise ValueError("model and args (TrainingArguments) required")
        if ignored:
            logger.info(f"HFTrainerAdapter ignoring kwargs: "
                        f"{sorted(ignored)}")
        from torchacc_tpu_torch.parallel.mesh import describe_mesh
        from torchacc_tpu_torch.train.accelerate import accelerate
        from torchacc_tpu_torch.train.schedules import (
            adamw,
            warmup_cosine,
            warmup_linear,
        )

        self.args = args
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.data_collator = data_collator
        self.tokenizer = tokenizer

        config = config or Config()
        if getattr(args, "bf16", False):
            config.compute.dtype = torch.bfloat16
        elif getattr(args, "fp16", False):
            config.compute.dtype = torch.float16
        accum = int(getattr(args, "gradient_accumulation_steps", 1) or 1)
        config.grad_accum = max(config.grad_accum, accum)

        self._hf_config = model.config

        # the mesh first: the schedule's horizon needs the global batch
        self._data_extent = 1
        if dist.is_initialized():
            sizes = describe_mesh(config.get_mesh(
                "cpu" if device is not None and torch.device(device).type
                == "cpu" else "cuda"))
            self._data_extent = max(sizes["dp"] * sizes["fsdp"], 1)
        total = self._planned_steps()
        warmup = int(getattr(args, "warmup_steps", 0) or 0)
        if not warmup and getattr(args, "warmup_ratio", 0.0):
            warmup = int(total * args.warmup_ratio)
        kind = str(getattr(args, "lr_scheduler_type", "linear"))
        lr = float(getattr(args, "learning_rate", 5e-5))
        if "cosine" in kind:
            sched = warmup_cosine(lr, total, warmup)
        elif "constant" in kind:
            sched = lr
        else:
            sched = warmup_linear(lr, total, warmup)
        if optimizer is None:
            optimizer = adamw(
                sched,
                weight_decay=float(getattr(args, "weight_decay", 0.0)),
                b1=float(getattr(args, "adam_beta1", 0.9)),
                b2=float(getattr(args, "adam_beta2", 0.999)),
                eps=float(getattr(args, "adam_epsilon", 1e-8)),
                grad_clip_norm=float(getattr(args, "max_grad_norm", 1.0))
                or None)

        self.config = config
        # the converted weights go straight into the masters (no random
        # init first), and the optimizer state starts from them
        self.trainer, _ = accelerate(model, None, config,
                                     optimizer=optimizer, device=device)
        self.model_config = self.trainer.model.cfg
        self._history = []

    # -- data ---------------------------------------------------------------
    def _global_batch_size(self, train: bool = True) -> int:
        key = ("per_device_train_batch_size" if train
               else "per_device_eval_batch_size")
        per_dev = int(getattr(self.args, key, 8) or 8)
        gbs = per_dev * self._data_extent
        if train:
            gbs *= max(int(getattr(self.args,
                                   "gradient_accumulation_steps", 1) or 1), 1)
        return gbs

    def _loader(self, dataset, train: bool = True,
                epoch: int = 0) -> Iterable[Dict[str, Any]]:
        import torch.utils.data as tud

        g = torch.Generator()
        # the epoch folded in, so that each epoch reshuffles
        # (transformers' set_epoch)
        g.manual_seed(int(getattr(self.args, "seed", 42)) + epoch)
        dl = tud.DataLoader(
            dataset, batch_size=self._global_batch_size(train),
            shuffle=train, drop_last=train,
            collate_fn=self.data_collator, generator=g)
        for batch in dl:
            yield _batch(batch)

    def _planned_steps(self) -> int:
        ms = int(getattr(self.args, "max_steps", -1) or -1)
        if ms > 0:
            return ms
        epochs = float(getattr(self.args, "num_train_epochs", 1.0))
        n = len(self.train_dataset) if self.train_dataset is not None else 0
        per_step = max(self._global_batch_size(train=True), 1)
        return max(int(epochs * (n // per_step)), 1)

    # -- the transformers.Trainer surface -----------------------------------
    def train(self):
        args = self.args
        max_steps = int(getattr(args, "max_steps", -1) or -1)
        epochs = (1 if max_steps > 0
                  else max(int(math.ceil(
                      float(getattr(args, "num_train_epochs", 1.0)))), 1))
        out_dir = getattr(args, "output_dir", None)
        save_steps = int(getattr(args, "save_steps", 0) or 0)
        log_steps = int(getattr(args, "logging_steps", 50) or 50)
        done = 0
        for epoch in range(epochs):
            history = self.trainer.fit(
                self._loader(self.train_dataset, epoch=epoch),
                max_steps=(max_steps - done if max_steps > 0 else None),
                checkpoint_dir=(out_dir if save_steps else None),
                checkpoint_every=max(save_steps, 1),
                log_every=log_steps,
                metrics_step_offset=done)
            self._history.extend(history)
            done += history[-1]["step"] + 1 if history else 0
            if max_steps > 0 and done >= max_steps:
                break
        return self._history

    def evaluate(self, eval_dataset=None) -> Dict[str, float]:
        ds = eval_dataset if eval_dataset is not None else self.eval_dataset
        if ds is None:
            raise ValueError("no eval_dataset")
        losses = [float(self.trainer.eval_step(b)["loss"])
                  for b in self._loader(ds, train=False)]
        if not losses:
            raise ValueError(
                f"eval_dataset yielded no batches (len={len(ds)})")
        return {"eval_loss": float(np.mean(losses))}

    def save_model(self, output_dir: Optional[str] = None) -> None:
        from torchacc_tpu_torch.checkpoint.io import save_checkpoint

        out = output_dir or getattr(self.args, "output_dir", None)
        if not out:
            raise ValueError("no output_dir")
        save_checkpoint(out, self.trainer.state, force=True)

    @property
    def state(self):
        return self.trainer.state
