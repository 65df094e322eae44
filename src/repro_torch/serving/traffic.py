"""Synthetic serving traffic: seeded Poisson arrivals, heavy tails.

A ``TrafficGenerator`` is a pure function of its seed: request ``i`` is
always the same (id, arrival time, prompt, target length, rng seed), no
matter when or where it is drawn. That determinism is what makes the
serving-plane migration gates checkable — a restored replica rebuilds
the generator from the seed recorded in the serving image, fast-forwards
past the requests the old replica already admitted, and sees exactly the
traffic the uninterrupted run would have seen.

Distributions (the live-serving shape the NERSC/DMTCP studies assume):

  * arrivals      Poisson — exponential inter-arrival gaps at ``rate``
                  requests per decode tick;
  * target length (session length) heavy-tailed — a clipped Pareto, so
                  most sessions are short and a few run very long;
  * prompt length heavy-tailed over a small DISCRETE support — Zipf
                  weights over ``prompt_support``, so the long-prompt
                  tail exists but prefill compiles stay bounded (each
                  distinct prompt length is one XLA specialization).

Example::

    gen = TrafficGenerator(seed=7, vocab_size=256)
    for req in gen.due(now=10.0):
        mgr.submit(req)
    gen2 = TrafficGenerator(seed=7, vocab_size=256)
    gen2.fast_forward(gen.emitted)        # replica resumes the stream
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One user session's worth of work: a prompt to prefill and a
    number of tokens to decode. ``rng_seed`` is the session's private
    sampling seed (migrates with the session, so sampled continuations
    stay deterministic too).

    Example::

        Request(sid="s0", arrival=0.7, prompt=np.array([5, 9, 2]),
                target=4, rng_seed=7000)
    """
    sid: str
    arrival: float
    prompt: np.ndarray
    target: int
    rng_seed: int


class TrafficGenerator:
    """Seeded request stream with a replayable cursor.

    ``emitted`` counts requests handed out through ``due()`` /
    ``take()``; ``fast_forward(n)`` burns the first ``n`` draws so a
    restored replica continues the exact stream. All draws come from one
    sequential ``numpy`` Generator — request i consumes a fixed number
    of draws, so the cursor alone reproduces the state.

    Example::

        gen = TrafficGenerator(seed=3, vocab_size=97, rate=2.0)
        reqs = gen.due(5.0)               # everything arriving by t=5
    """

    def __init__(self, *, seed: int, vocab_size: int, rate: float = 1.0,
                 prompt_support: tuple = (4, 6, 8, 12, 16),
                 prompt_zipf_s: float = 1.5,
                 target_alpha: float = 1.2, target_scale: float = 3.0,
                 target_max: int = 48):
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.rate = float(rate)
        self.prompt_support = tuple(int(s) for s in prompt_support)
        self.prompt_zipf_s = float(prompt_zipf_s)
        self.target_alpha = float(target_alpha)
        self.target_scale = float(target_scale)
        self.target_max = int(target_max)
        w = np.array([1.0 / (k + 1) ** self.prompt_zipf_s
                      for k in range(len(self.prompt_support))])
        self._prompt_p = w / w.sum()
        self._rng = np.random.default_rng(self.seed)
        self._now = 0.0
        self.emitted = 0
        self._pending: Request | None = None   # drawn but not yet due

    # ------------------------------------------------------------ drawing
    def _draw(self) -> Request:
        i = self.emitted        # _draw only runs with no pending request
        gap = float(self._rng.exponential(1.0 / self.rate))
        plen = int(self._rng.choice(self.prompt_support, p=self._prompt_p))
        target = min(self.target_max,
                     1 + int(self._rng.pareto(self.target_alpha)
                             * self.target_scale))
        prompt = self._rng.integers(
            0, self.vocab_size, size=plen).astype(np.int32)
        self._now += gap
        return Request(sid=f"s{i}", arrival=self._now, prompt=prompt,
                       target=target, rng_seed=self.seed * 100_000 + i)

    # ------------------------------------------------------------- stream
    def due(self, now: float) -> list:
        """Every request with ``arrival <= now`` not yet emitted, in
        arrival order. Advances the cursor."""
        out = []
        while True:
            if self._pending is None:
                self._pending = self._draw()
            if self._pending.arrival > now:
                return out
            out.append(self._pending)
            self.emitted += 1
            self._pending = None

    def take(self, n: int) -> list:
        """The next ``n`` requests regardless of arrival time (offline /
        batch admission). Advances the cursor."""
        out = []
        for _ in range(int(n)):
            if self._pending is None:
                self._pending = self._draw()
            out.append(self._pending)
            self.emitted += 1
            self._pending = None
        return out

    def fast_forward(self, n: int):
        """Discard the first ``n`` requests — how a restored replica
        aligns a fresh generator with the serving image's cursor."""
        if self.emitted or self._pending is not None:
            raise RuntimeError("fast_forward() only on a fresh generator")
        for _ in range(int(n)):
            self._draw()
            self.emitted += 1

    def state(self) -> dict:
        """JSON cursor for serve-plane metadata. Carries the distribution
        parameters too: a restorer that rebuilt the generator with
        different ``prompt_support``/``target_*`` would silently diverge
        from the dumped stream, so ``from_state`` reads them back instead
        of trusting constructor defaults."""
        return {"seed": self.seed, "emitted": int(self.emitted),
                "rate": self.rate, "vocab_size": self.vocab_size,
                "prompt_support": list(self.prompt_support),
                "prompt_zipf_s": self.prompt_zipf_s,
                "target_alpha": self.target_alpha,
                "target_scale": self.target_scale,
                "target_max": self.target_max}

    @classmethod
    def from_state(cls, cur: dict, **overrides):
        """Rebuild a generator from a ``state()`` cursor and fast-forward
        to its position — the restore half of the replayable stream.
        Cursor fields missing from old images fall back to constructor
        defaults (or ``overrides``).

        Example::

            gen2 = TrafficGenerator.from_state(src_gen.state())
            gen2.take(1)           # the request the source would emit next
        """
        kw = {k: cur[k] for k in
              ("seed", "vocab_size", "rate", "prompt_support",
               "prompt_zipf_s", "target_alpha", "target_scale",
               "target_max") if k in cur}
        kw.update(overrides)
        gen = cls(**kw)
        gen.fast_forward(int(cur.get("emitted", 0)))
        return gen
