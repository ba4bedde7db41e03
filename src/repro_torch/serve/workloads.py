"""Serving workloads beyond LM chat, through the unchanged ServeEngine.

A workload is a thin driver that maps its domain requests onto
:class:`repro_torch.serve.session.Request` objects and reads the emitted
tokens:

:class:`TranscriptionService`
    Streaming audio transcription on an enc-dec arch (whisper-tiny): each
    :class:`TranscriptStream` window becomes one session whose context is
    the window's frames (encoded once at admission) and whose prompt
    carries the tail of the transcript so far.  Windows of one stream run
    in order; windows of different streams interleave in the slot pool.
    Sampling folds (rid, step) into the engine's key, so any slot count
    gives the same transcripts.

:class:`ClassifierService`
    The paper's XNOR-CNN image classification (Fig. 6) as a batched
    service: one-shot sessions (one ``QUERY_TOKEN`` prompt, the image's
    pixel bands as context, ``max_new_tokens=1``), greedy: the emitted
    token is the class id.  With ``pack=True`` the resident weights are
    packed sign planes, so each classification runs the fused XNOR
    linear; the packed and float-sign paths give the same classes.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.session import Request, TranscriptStream


class TranscriptionService:
    """Streaming transcription over one enc-dec serve engine.

    ``carry`` trailing transcript tokens condition each next window;
    ``tokens_per_window`` is each window's budget (eos is off, so budgets
    and prompt shapes do not depend on the schedule).  Each
    :meth:`transcribe` builds its own engine: window rids come from stream
    ids, so a fresh call gets a fresh rid space.
    """

    _RID_STRIDE = 1 << 20              # rid = sid * stride + window index

    def __init__(self, cfg, params, *, slots: int = 4, s_max: int = 32,
                 tokens_per_window: int = 4, carry: int = 8,
                 temperature: float = 0.8, seed: int = 0, bos_id: int = 1,
                 device="cuda", **engine_kw: Any):
        if not cfg.is_encdec():
            raise ValueError(f"transcription needs an enc-dec arch, "
                             f"got {cfg.name}")
        if 1 + carry + tokens_per_window - 1 > s_max:
            raise ValueError(f"carry={carry} + budget={tokens_per_window} "
                             f"does not fit s_max={s_max}")
        self.cfg = cfg
        self.params = params
        self.tokens_per_window = tokens_per_window
        self.carry = carry
        self.bos_id = bos_id
        self._engine_kw = dict(slots=slots, s_max=s_max, eos_id=None,
                               temperature=temperature, seed=seed,
                               device=device, **engine_kw)
        self.stats = None              # EngineStats of the last transcribe()

    def _prompt(self, transcript: list[int]) -> np.ndarray:
        return np.asarray([self.bos_id] + transcript[-self.carry:], np.int32)

    def transcribe(self, streams: list[TranscriptStream]
                   ) -> dict[int, list[int]]:
        """Drain every stream -> {sid: transcript tokens}.  Each stream's
        next window is submitted as soon as its previous one finishes,
        then the engine steps once: a window's prompt does not exist
        before its predecessor's tokens do."""
        streams = sorted(streams, key=lambda s: s.sid)
        if len({s.sid for s in streams}) != len(streams):
            raise ValueError("duplicate stream ids")
        engine = ServeEngine(self.cfg, self.params, **self._engine_kw)
        transcripts: dict[int, list[int]] = {s.sid: [] for s in streams}
        nxt = {s.sid: 0 for s in streams}
        busy: set[int] = set()         # sids with a window in flight
        inflight: dict[int, int] = {}  # rid -> sid

        def submit_ready():
            for s in streams:
                if s.sid in busy or nxt[s.sid] >= len(s.windows):
                    continue
                w = nxt[s.sid]
                rid = s.sid * self._RID_STRIDE + w
                engine.submit(Request(
                    rid=rid, prompt=self._prompt(transcripts[s.sid]),
                    max_new_tokens=self.tokens_per_window,
                    ctx=np.asarray(s.windows[w], np.float32)))
                inflight[rid] = s.sid
                busy.add(s.sid)
                nxt[s.sid] = w + 1

        submit_ready()
        while inflight:
            engine.step()
            done = [rid for rid in inflight if engine.sessions[rid].done]
            for rid in done:
                sid = inflight.pop(rid)
                busy.discard(sid)
                transcripts[sid].extend(engine.sessions[rid].tokens)
            if done:
                submit_ready()
        self.stats = engine.stats
        return transcripts


class ClassifierService:
    """Batched XNOR-CNN classification behind the engine's admission and
    slots.  One persistent engine: requests finish at their prefill
    sample, so slots turn over every step and n images drain in about
    ceil(n / slots) engine steps.  Without ``params`` the classifier is
    trained first (``bcnn.train_classifier``, ``train_steps`` steps)."""

    def __init__(self, cfg=None, params=None, *, slots: int = 4,
                 s_max: int = 8, pack: bool = True, seed: int = 0,
                 train_steps: int = 150, device="cuda", **engine_kw: Any):
        from repro_torch import configs
        from repro_torch.models import bcnn
        self._bcnn = bcnn
        self.cfg = cfg if cfg is not None else configs.get("xnor-cnn")
        self.train_acc = None
        if params is None:
            params, self.train_acc = bcnn.train_classifier(
                self.cfg, steps=train_steps, seed=seed, device=device)
        self.params = params
        self.engine = ServeEngine(self.cfg, self.params, slots=slots,
                                  s_max=s_max, eos_id=None, temperature=0.0,
                                  pack=pack, seed=seed, device=device,
                                  **engine_kw)
        self._next_rid = 0

    def classify(self, images) -> np.ndarray:
        """(N, H, W) images -> (N,) class ids (greedy, so deterministic)."""
        ctx = self._bcnn.image_ctx(self.cfg, images)
        prompt = np.asarray([self._bcnn.QUERY_TOKEN], np.int32)
        rid0 = self._next_rid
        for i in range(ctx.shape[0]):
            self.engine.submit(Request(rid=rid0 + i, prompt=prompt,
                                       max_new_tokens=1, ctx=ctx[i]))
        self._next_rid += ctx.shape[0]
        while self.engine.step():
            pass
        return np.asarray(
            [self.engine.sessions[rid0 + i].tokens[0]
             for i in range(ctx.shape[0])], np.int32)

    @property
    def stats(self):
        return self.engine.stats
