"""The ES tier running offloaded inference jobs: `models.forward` +
`logits_from_h` on one class's batch a step (64 x 128, 16 x 512 or 8 x
1024 tokens, the fleet's job classes), each job's answer the greedy
token at every position, each step synchronised.

Once the window has closed, a sample of its steps drawn from the seed
(the first of the longest class among them) is worked out again by the
plain float32 reference on the same batch: every position's answer must
lie within the limit of the reference's best logit."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench import common, lmgen, work
from portbench.reference import lm_ref

# the mean gap (reference logits) between the reference's best token and
# the served one, over the checked answers; see PERF.md for the readings
# it was set from
LIMITS = {"logit_gap_mean": 0.02}


class Driver:
    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: torch.device):
        from repro_torch import models
        self.models = models
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.mcfg = lmgen.model_config(config)
        self.params = lmgen.make_params(config, common.stream_seed(seed, 0),
                                        device)
        tokens = int(traffic["tokens_per_step"])
        self.shapes = [(tokens // s, s) for s in traffic["classes"]]
        n_pool = int(traffic["pool_batches"])
        self.pool = lmgen.token_pool(
            n_pool * len(self.shapes), tokens, int(config["vocab_size"]),
            common.stream_seed(seed, 1), device)
        # every seed runs the same classes in the same proportion: blocks
        # of one step per class, in an order drawn from the seed
        rng = np.random.default_rng(common.stream_seed(seed, 2))
        self.order = np.concatenate([rng.permutation(len(self.shapes))
                                     for _ in range(4096)])
        self.answers: List[torch.Tensor] = []
        with torch.no_grad():
            for c, shape in enumerate(self.shapes):
                self._run(self.pool[c].view(shape))

    def _batch(self, i: int):
        c = int(self.order[i])
        B, S = self.shapes[c]
        row = (i // len(self.shapes)) % (self.pool.shape[0]
                                         // len(self.shapes))
        return c, self.pool[row * len(self.shapes) + c].view(B, S)

    def _run(self, tok: torch.Tensor) -> torch.Tensor:
        h = self.models.forward(self.params, {"tokens": tok}, self.mcfg)
        ans = self.models.logits_from_h(self.params, h, self.mcfg).argmax(-1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return ans

    def step(self, i: int) -> None:
        with torch.no_grad():
            self.answers.append(self._run(self._batch(i)[1]))

    def _flops(self, steps: int) -> float:
        total = 0
        for i in range(steps):
            B, S = self.shapes[int(self.order[i])]
            total += (B * S * work.lm_matmul_flops_per_token(self.cfg)
                      + work.lm_attention_flops(self.cfg, B, S, S))
        return float(total)

    def end_to_end(self, times: List[float]) -> Dict[str, float]:
        tokens = int(self.traffic["tokens_per_step"])
        return {"tokens_per_s": tokens * len(times) / sum(times),
                "step_p95_ms": common.quantile(times, 0.95) * 1e3}

    def outcome(self):
        """(attempted, failed): jobs (batch rows) run in the window, none of
        which can fail short of an exception."""
        return sum(self.shapes[int(self.order[i])][0]
                   for i in range(len(self.answers))), 0

    def layer_context(self, times: List[float]) -> Dict[str, Any]:
        return {"kind": "lm", "steps": len(times), "window_s": sum(times),
                "model_flops": self._flops(len(times))}

    def traced(self, trace_fn):
        """Profile ``trace_steps`` steps (the window's first, one per class
        in its block order) and count their flash calls' bound."""
        n = int(self.traffic["trace_steps"])

        def run():
            with torch.no_grad():
                for i in range(n):
                    self._run(self._batch(i)[1])
        summary = trace_fn(run)
        s = work.lm_dims(self.cfg)
        bound = 0.0
        for i in range(n):
            B, S = self.shapes[int(self.order[i])]
            nb, fl = work.flash_work(B, S, S, s["H"], s["KH"], s["Hd"],
                                     "causal", 0, 2)
            bound += s["L"] * work.bound_s(nb, fl, work.PEAK_BF16_FLOPS)
        return summary, {"steps_traced": n, "flash_bound_s": bound}

    def release(self) -> None:
        """Nothing of the program's outlives a step but the answers."""

    def checked_batches(self):
        """(tokens, the program's answers, the reference's dispatch) of the
        sampled steps: drawn from the seed, one of the longest class
        among them."""
        rng = np.random.default_rng(common.stream_seed(self.seed, 3))
        n = len(self.answers)
        k = min(int(self.traffic["check_steps"]), n)
        picks = list(rng.choice(n, size=k, replace=False))
        longest = max(range(len(self.shapes)),
                      key=lambda c: self.shapes[c][1])
        if not any(int(self.order[i]) == longest for i in picks):
            picks[0] = next(i for i in range(n)
                            if int(self.order[i]) == longest
                            and i not in picks)
        for i in picks:
            _c, tok = self._batch(i)
            N = tok.numel()
            yield tok, self.answers[i], dict(
                group=lm_ref.groups_of(N, self.cfg), n_grouped=N)

    def check(self) -> List[Dict[str, Any]]:
        """The mean gap of the checked answers below the reference's best
        logit at their positions."""
        return lm_ref.check(self.params, self.cfg, self.checked_batches(),
                            LIMITS)
