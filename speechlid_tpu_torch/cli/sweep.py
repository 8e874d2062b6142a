"""Hyperparameter sweep driver (port of ``speechlid_tpu/cli/sweep.py``;
reference: wandb bayes sweeps, which re-launched the entry point with
sampled CLI overrides to optimize a monitored metric).

Launches the port's ``cli.main_lid.main`` in-process with sampled
``key=value`` overrides (and ``--device``) and reads the monitored metric
from the run's metrics.jsonl, so every trial trains on the card unless
``--device cpu`` asks for the CPU.  Methods:

- ``random`` / ``grid`` — as in wandb;
- ``bayes`` — sequential model-based optimization via a TPE
  (Tree-structured Parzen Estimator): after ``n_startup`` random trials,
  split history at the γ-quantile into good/bad sets, sample candidates
  from the good-set density and rank by the l(x)/g(x) density ratio.

The same ``random.Random(seed)`` stream as the JAX sweep, so the same spec
and history give the same suggestions.  The spec is read with
``core/config.safe_load`` (PyYAML is not needed).  A failing trial does not
end the sweep: its exception is logged with the traceback and the trial is
recorded with the value ``None``, as in the JAX sweep.

Sweep spec (YAML):
    method: bayes             # random | grid | bayes
    metric: {name: avg_val_loss, goal: minimize}
    trials: 10
    n_startup: 5              # bayes: random warmup trials
    program_config: lid_supervised
    base_overrides: ["trainer.total_epoch=3", ...]
    parameters:
      module.lr: {distribution: log_uniform, min: 1e-4, max: 1e-2}
      module.dropout: {values: [0.0, 0.1, 0.2]}
      data.batch_size: {distribution: int_uniform, min: 4, max: 16}

Usage:
    python -m speechlid_tpu_torch.cli.sweep configs/sweep_lid.yaml \
        [--config-dir configs] [--out exp/sweep] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import math
import os
import random
from typing import Any, Dict, List

from speechlid_tpu_torch.core.config import safe_load


def _sample(spec: Dict, rng: random.Random) -> Any:
    if "values" in spec:
        return rng.choice(spec["values"])
    dist = spec.get("distribution", "uniform")
    lo, hi = float(spec["min"]), float(spec["max"])
    if dist == "log_uniform":
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    if dist == "int_uniform":
        return rng.randint(int(lo), int(hi))
    return rng.uniform(lo, hi)


def _grid(params: Dict) -> List[Dict]:
    keys = list(params)
    values = [params[k]["values"] for k in keys]
    return [dict(zip(keys, combo)) for combo in itertools.product(*values)]


class TPESampler:
    """Tree-structured Parzen Estimator over a flat parameter spec.

    Numeric params are modeled with per-observation Gaussian kernels (in
    log space for log_uniform); categoricals with add-one reweighting.
    ``suggest`` draws ``n_candidates`` from the good-set model and returns
    the candidate maximizing Σ log l(x) − log g(x).
    """

    def __init__(self, params: Dict, rng: random.Random, n_startup: int = 5,
                 gamma: float = 0.25, n_candidates: int = 24,
                 epsilon: float = 0.25):
        self.params = params
        self.rng = rng
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        # ε fraction of suggestions stay pure-random: the argmax-l/g rule
        # otherwise collapses onto the first decent basin (tiny data-driven
        # bandwidths → microscopic proposals) and never escapes
        self.epsilon = epsilon

    # ---- numeric helpers (operate in transformed space)
    def _space(self, spec):
        dist = spec.get("distribution", "uniform")
        lo, hi = float(spec["min"]), float(spec["max"])
        if dist == "log_uniform":
            return math.log(lo), math.log(hi), dist
        return lo, hi, dist

    def _to_value(self, z, spec):
        lo, hi, dist = self._space(spec)
        z = min(max(z, lo), hi)
        if dist == "log_uniform":
            return math.exp(z)
        if dist == "int_uniform":
            return int(round(z))
        return z

    def _to_z(self, v, spec):
        _, _, dist = self._space(spec)
        return math.log(v) if dist == "log_uniform" else float(v)

    def _bandwidth(self, zs, spec):
        """Scott-style data-driven bandwidth: wide while observations are
        spread, tightening as the good set concentrates."""
        lo, hi, _ = self._space(spec)
        n = len(zs)
        mean = sum(zs) / n
        std = math.sqrt(sum((z - mean) ** 2 for z in zs) / n)
        return max(std, 0.05 * (hi - lo)) * n ** -0.2 + 1e-12

    def _kde_sample(self, zs, spec):
        sigma = self._bandwidth(zs, spec)
        center = self.rng.choice(zs)
        return self.rng.gauss(center, sigma)

    def _kde_logpdf(self, z, zs, spec):
        sigma = self._bandwidth(zs, spec)
        acc = 0.0
        for c in zs:
            acc += math.exp(-0.5 * ((z - c) / sigma) ** 2)
        return math.log(acc / (len(zs) * sigma) + 1e-300)

    def _cat_logp(self, v, observed, values):
        n = len(observed)
        k = len(values)
        count = sum(1 for o in observed if o == v)
        return math.log((count + 1.0) / (n + k))

    def suggest(self, history: List[Dict], metric: str, goal: str) -> Dict:
        """history: completed trials (dicts incl. the metric value)."""
        done = [h for h in history if h.get(metric) is not None]
        if len(done) < self.n_startup or self.rng.random() < self.epsilon:
            return {k: _sample(v, self.rng) for k, v in self.params.items()}
        done = sorted(done, key=lambda h: h[metric],
                      reverse=(goal == "maximize"))
        n_good = max(1, int(math.ceil(self.gamma * len(done))))
        good, bad = done[:n_good], done[n_good:] or done[:1]

        best, best_score = None, -float("inf")
        for ci in range(self.n_candidates):
            # a quarter of candidates come from the uniform prior so the
            # search never collapses onto the warmup's mediocre modes
            # (optuna-style prior mixing)
            from_prior = ci % 4 == 3
            cand, score = {}, 0.0
            for key, spec in self.params.items():
                if "values" in spec:
                    gvals = [h[key] for h in good]
                    bvals = [h[key] for h in bad]
                    if from_prior:
                        v = self.rng.choice(spec["values"])
                    else:
                        weights = [
                            math.exp(self._cat_logp(v, gvals, spec["values"]))
                            for v in spec["values"]
                        ]
                        total = sum(weights)
                        r = self.rng.uniform(0, total)
                        acc = 0.0
                        v = spec["values"][-1]
                        for val, w in zip(spec["values"], weights):
                            acc += w
                            if r <= acc:
                                v = val
                                break
                    cand[key] = v
                    score += (self._cat_logp(v, gvals, spec["values"])
                              - self._cat_logp(v, bvals, spec["values"]))
                else:
                    gz = [self._to_z(h[key], spec) for h in good]
                    bz = [self._to_z(h[key], spec) for h in bad]
                    if from_prior:
                        lo, hi, _ = self._space(spec)
                        z = self.rng.uniform(lo, hi)
                    else:
                        z = self._kde_sample(gz, spec)
                    cand[key] = self._to_value(z, spec)
                    score += (self._kde_logpdf(z, gz, spec)
                              - self._kde_logpdf(z, bz, spec))
            if score > best_score:
                best, best_score = cand, score
        return best


def _read_last_metric(metrics_path: str, name: str):
    value = None
    if not os.path.exists(metrics_path):
        return None
    with open(metrics_path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if name in rec:
                value = rec[name]
    return value


def run_sweep_spec(
    spec: Dict, config_dir: str = "configs", out_root: str = "exp/sweep",
    objective=None, device: str = "cuda",
) -> List[Dict]:
    """``objective(sample) -> value`` overrides the default train-and-read
    objective (used by tests and custom metrics).  → the trials, the
    successful ones first, best first."""
    rng = random.Random(spec.get("seed", 0))
    metric = spec["metric"]["name"]
    goal = spec["metric"].get("goal", "minimize")
    params = spec.get("parameters", {})
    method = spec.get("method", "random")
    n_trials = int(spec.get("trials", 10))

    if objective is None:
        from speechlid_tpu_torch.cli.main_lid import main as train_main

        def objective(sample, trial=[0]):  # noqa: B006 - counter cell
            i = trial[0]
            trial[0] += 1
            exp_dir = os.path.join(out_root, f"trial_{i}")
            overrides = list(spec.get("base_overrides", []))
            overrides += [f"{k}={v}" for k, v in sample.items()]
            overrides += [f"exp_dir={exp_dir}"]
            train_main(
                ["--config-dir", config_dir, "--device", device,
                 "--config-name", spec["program_config"], *overrides]
            )
            return _read_last_metric(
                os.path.join(exp_dir, "metrics.jsonl"), metric
            )

    sampler = None
    if method == "grid":
        samples = _grid(params)
    elif method == "bayes":
        sampler = TPESampler(
            params, rng,
            n_startup=int(spec.get("n_startup", 5)),
            gamma=float(spec.get("gamma", 0.25)),
        )
        samples = [None] * n_trials  # suggested sequentially below
    else:
        samples = [
            {k: _sample(v, rng) for k, v in params.items()}
            for _ in range(n_trials)
        ]

    results = []
    for i, sample in enumerate(samples):
        if sampler is not None:
            sample = sampler.suggest(results, metric, goal)
        logging.info("sweep trial %d: %s", i, sample)
        try:
            value = objective(sample)
        except Exception:  # a diverged trial shouldn't kill the sweep
            logging.exception("trial %d failed", i)
            value = None
        results.append({"trial": i, **sample, metric: value})
    ok = [r for r in results if r[metric] is not None]
    ok.sort(key=lambda r: r[metric], reverse=(goal == "maximize"))
    out_path = os.path.join(out_root, "results.jsonl")
    os.makedirs(out_root, exist_ok=True)
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    logging.info("sweep best: %s", ok[0] if ok else None)
    return ok + [r for r in results if r[metric] is None]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("sweep_yaml")
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--out", default="exp/sweep")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    with open(args.sweep_yaml) as f:
        spec = safe_load(f.read())
    return run_sweep_spec(spec, args.config_dir, args.out, device=args.device)


if __name__ == "__main__":
    main()
