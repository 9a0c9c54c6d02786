"""Deterministic, checkpointable synthetic data pipeline — port of
``repro/data/pipeline.py``.

Training needs a pipeline whose state is tiny (one integer), exactly
resumable after a restart, and the same however many hosts feed it.
Counter-keyed synthesis gives all three: batch ``i`` is a pure function of
``(seed, i)``, so a checkpoint stores only the step cursor.  The
synthesis is the reference's numpy code, so every ``(seed, step)`` gives
the reference's batch bit for bit; ``next_batch`` puts it on a device as
tensors (token ids as int64, the index dtype of ``torch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class PipelineState:
    """The entire checkpointable state: a cursor."""
    step: int = 0


class TokenPipeline:
    """Counter-keyed synthetic LM batches with a Zipf-ish unigram mix —
    enough signal for loss-goes-down checks while staying fully
    deterministic and restart-exact."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.cfg = cfg
        self.batch = batch_override or shape.global_batch
        self.seq = seq_override or shape.seq_len
        self.seed = seed
        self.state = PipelineState()

    # -- synthesis -------------------------------------------------------

    def _synth(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        v = cfg.vocab_size
        s_text = self.seq
        if cfg.n_patches:
            s_text = max(self.seq - cfg.n_patches, 8)
        # Zipf-ish unigram distribution + short-range repetition structure
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(self.batch, s_text + 1), p=probs)
        rep = rng.random((self.batch, s_text + 1)) < 0.3
        rep[:, 0] = False
        idx = np.where(rep)
        toks[idx] = toks[idx[0], idx[1] - 1]       # 30% copy-previous
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.n_encoder_layers:
            batch["frames"] = rng.standard_normal(
                (self.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.n_patches:
            batch["patches"] = rng.standard_normal(
                (self.batch, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
        return batch

    # -- iteration -------------------------------------------------------

    def next_batch(self, device="cuda") -> Dict[str, torch.Tensor]:
        """Next global batch as tensors on ``device``: token ids int64,
        stub modality inputs float32."""
        dev = resolve_device(device)
        host = self._synth(self.state.step)
        self.state.step += 1
        return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32 else None,
                                   device=dev)
                for k, v in host.items()}

    def peek(self, step: int) -> Dict[str, np.ndarray]:
        """Batch ``step`` without advancing (determinism tests)."""
        return self._synth(step)

    # -- checkpointing ----------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.state.step, "seed": self.seed}

    def load_state_dict(self, d: Dict[str, int]):
        if d["seed"] != self.seed:       # the reference's assert, kept under -O
            raise AssertionError("pipeline seed mismatch on restore")
        self.state.step = int(d["step"])
