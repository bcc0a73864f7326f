"""An ES server decoding a batch: the prompts prefilled into the cache
during set-up (`models.prefill`), then `decode_step` after `decode_step`,
each step synchronised.  Each sequence is fed its continuation drawn from
the seed (teacher-forced, as a scorer or a verifier of proposed tokens
reads them), so the work never depends on the answers; each step's
answer is the greedy token of every sequence.  (Fed its own greedy
tokens, a model with random weights falls into a loop of one or two
tokens within a few dozen steps, whose answers no precision can get
wrong, so they would check nothing.)

Once the window has closed, every sequence is worked out again by the
plain float32 reference over its prompt and the tokens fed: the gaps of
the answers below the reference's best logit at their positions must lie
within the limit."""
from __future__ import annotations

from typing import Any, Dict, List

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
        self.B, self.P = int(traffic["batch"]), int(traffic["prompt_len"])
        self.max_seq = int(traffic["max_seq"])
        self.prompts = lmgen.token_pool(self.B, self.P,
                                        int(config["vocab_size"]),
                                        common.stream_seed(seed, 1), device)
        self.fed = lmgen.token_pool(self.B, self.max_seq - self.P,
                                    int(config["vocab_size"]),
                                    common.stream_seed(seed, 2), device)
        self.served = torch.zeros((self.B, self.max_seq - self.P),
                                  dtype=torch.long, device=device)
        with torch.no_grad():
            self.cache, logits = models.prefill(
                self.params, {"tokens": self.prompts}, self.mcfg,
                self.max_seq)
            self.served[:, 0] = logits[:, -1].argmax(-1)
            self.n = 1
            for _ in range(int(traffic["warmup_steps"])):
                self._decode()

    def _decode(self) -> None:
        if self.P + self.n >= self.max_seq:
            raise RuntimeError(f"the cache of {self.max_seq} slots is full")
        logits, self.cache = self.models.decode_step(
            self.params, self.fed[:, self.n - 1:self.n], self.cache,
            self.mcfg)
        self.served[:, self.n] = logits[:, -1].argmax(-1)
        self.n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int) -> None:
        if i == 0:
            self.n0 = self.n
        with torch.no_grad():
            self._decode()

    def _flops(self, first: int, steps: int) -> float:
        per_token = work.lm_matmul_flops_per_token(self.cfg)
        return float(sum(
            self.B * per_token + work.lm_attention_flops(
                self.cfg, self.B, 1, self.P + n)
            for n in range(first, first + steps)))

    def end_to_end(self, times: List[float]) -> Dict[str, float]:
        return {"tokens_per_s": self.B * len(times) / sum(times),
                "step_p95_ms": common.quantile(times, 0.95) * 1e3}

    def outcome(self):
        """(attempted, failed): tokens generated in the window, none of
        which can fail short of an exception."""
        return self.B * (self.n - self.n0), 0

    def layer_context(self, times: List[float]) -> Dict[str, Any]:
        return {"kind": "lm", "steps": len(times), "window_s": sum(times),
                "model_flops": self._flops(self.n0, len(times))}

    def traced(self, trace_fn):
        """Profile ``trace_steps`` further decode steps and count their
        flash-decode calls' bound."""
        n = int(self.traffic["trace_steps"])
        first = self.n

        def run():
            with torch.no_grad():
                for _ in range(n):
                    self._decode()
        summary = trace_fn(run)
        s = work.lm_dims(self.cfg)
        bound = 0.0
        for k in range(first, first + n):
            # the step of served token k attends to the P + k cache slots
            nb, fl = work.decode_work(self.B, s["H"], s["KH"], s["Hd"],
                                      self.P + k, 2, 2)
            bound += s["L"] * work.bound_s(nb, fl, work.PEAK_BF16_FLOPS)
        return summary, {"steps_traced": n, "decode_bound_s": bound}

    def release(self) -> None:
        self.cache = None

    def checked_batches(self):
        """(tokens, the answers, the reference's dispatch) of every
        sequence: its prompt and the tokens fed after it, the prompt
        dispatched as the prefill dispatched it (its groups lie within one
        sequence), the fed tokens undropped, the logits of the positions
        that chose an answer."""
        group = lm_ref.groups_of(self.B * self.P, self.cfg)
        if self.P % group:
            raise ValueError(f"a prefill dispatch group of {group} tokens "
                             f"spans sequences of {self.P}")
        rows = torch.arange(self.P - 1, self.P - 1 + self.n,
                            device=self.device)
        for b in range(self.B):
            served = self.served[b, :self.n]
            seq = torch.cat([self.prompts[b], self.fed[b, :self.n - 1]])[None]
            yield seq, served, dict(group=group, n_grouped=self.P,
                                    rows=rows)

    def check(self) -> List[Dict[str, Any]]:
        """The mean gap of the checked answers below the reference's best
        logit at their positions."""
        return lm_ref.check(self.params, self.cfg, self.checked_batches(),
                            LIMITS)
