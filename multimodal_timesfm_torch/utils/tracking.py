"""Experiment tracking: optional W&B and an offline local sweep engine.

The port's own copy of ``multimodal_timesfm_tpu/utils/tracking.py`` (which
imports no JAX; the port imports nothing of that package). W&B stays
optional: the import is gated, and sweeps also run fully offline.
``LocalSweep`` samples the W&B sweep-YAML parameter space (``value``,
``values``, ``uniform``, ``log_uniform_values``, ``int_uniform``) and logs
results to ``sweep_results.jsonl``.

``LocalSweep`` dispatches on the YAML's ``method`` key: "bayes" runs a
Tree-structured Parzen Estimator (TPE) over the parsed space, pure numpy,
fed back from each trial's logged target metric and kept durably in
``sweep_state.jsonl``; anything else samples at random. From the same seed
it draws the same configs as the JAX package's engine.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any

import numpy as np


def try_import_wandb() -> Any:
    """Return the wandb module or None (optional dependency)."""
    try:
        import wandb

        return wandb
    except ImportError:
        return None


class LocalRun:
    """Minimal stand-in for a wandb Run: .config attribute access + .log to JSONL."""

    def __init__(self, run_id: str, config: dict[str, Any], log_path: Path) -> None:
        self.id = run_id
        self.config = _Config(config)
        self.summary: dict[str, Any] = {}
        self._log_path = log_path
        self._log_path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        record = {"run_id": self.id, "step": step, "time": time.time(), **metrics}
        self.summary.update(metrics)
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def __enter__(self) -> "LocalRun":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


class _Config:
    """dict with attribute + .get access, like wandb's run config."""

    def __init__(self, values: dict[str, Any]) -> None:
        self._values = dict(values)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def __iter__(self) -> Any:
        return iter(self._values)

    def items(self) -> Any:
        return self._values.items()


class LocalSweep:
    """Offline sampler over a W&B sweep-YAML parameter space.

    ``method: bayes`` (what the shipped sweep YAMLs declare) runs TPE:
    observed trials are split into a good quantile and the rest, each
    parameter gets a Parzen (kernel-density / categorical-count) model per
    split, and candidates drawn from the *good* model are ranked by the
    density ratio l(x)/g(x). Continuous parameters are modeled in their
    sampling space (log-space for ``log_uniform_values``). Any other method
    — or a ``bayes`` sweep before ``n_startup`` observations exist — samples
    uniformly at random.
    """

    def __init__(
        self,
        sweep_config: dict[str, Any],
        output_dir: Path,
        seed: int = 0,
        n_startup: int = 10,
        n_candidates: int = 24,
        gamma: float = 0.25,
    ) -> None:
        self.parameters = sweep_config.get("parameters", {})
        self.metric = sweep_config.get("metric", {})
        self.method = sweep_config.get("method", "random")
        self.output_dir = Path(output_dir)
        self._rng = np.random.default_rng(seed)
        self._n_startup = n_startup
        self._n_candidates = n_candidates
        self._gamma = gamma
        # (config, value) pairs, value oriented so that LOWER is better.
        self._observations: list[tuple[dict[str, Any], float]] = []
        # Durable surrogate state: observations persist to sweep_state.jsonl,
        # so a crashed/re-launched sweep resumes its TPE history instead of
        # restarting the sampler cold (the W&B service gives the reference
        # this for free; offline it has to live on disk).
        self._state_path = self.output_dir / "sweep_state.jsonl"
        if self._state_path.exists():
            for line in self._state_path.read_text().splitlines():
                try:
                    rec = json.loads(line)
                    self._observations.append((rec["config"], float(rec["value"])))
                except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                    continue  # partial line from a crash mid-write
        # A resumed sweep must not REPLAY the base seed's draw sequence —
        # with the same seed, relaunched random/startup trials would sample
        # the exact configs already tried. Fold the resume position into the
        # seed so every relaunch explores a fresh stream (still deterministic
        # given the on-disk history).
        resumed_at = self.next_trial_index()
        if resumed_at:
            self._rng = np.random.default_rng([seed, resumed_at])

    # -- random sampling ----------------------------------------------------

    @staticmethod
    def _resolve_distribution(spec: dict[str, Any]) -> str:
        """Distribution name for a min/max spec, with W&B's implicit default.

        W&B treats a bare ``{min, max}`` spec (no ``distribution`` key) as
        ``int_uniform`` when both bounds are ints, ``uniform`` otherwise —
        sweep YAMLs written for the W&B agent must sample the same way
        offline. Raises a spec-naming ValueError for anything else
        (including distributions that lack min/max) instead of dying on
        ``float(None)``.
        """
        if "min" not in spec or "max" not in spec:
            raise ValueError(f"Unsupported parameter spec (needs min/max): {spec}")
        dist = spec.get("distribution")
        if dist is None:
            both_int = isinstance(spec["min"], int) and isinstance(spec["max"], int)
            return "int_uniform" if both_int else "uniform"
        if dist not in ("uniform", "log_uniform_values", "int_uniform"):
            raise ValueError(f"Unsupported parameter spec: {spec}")
        return dist

    def _sample_one(self, spec: dict[str, Any]) -> Any:
        if "value" in spec:
            return spec["value"]
        if "values" in spec:
            values = spec["values"]
            return values[int(self._rng.integers(len(values)))]
        dist = self._resolve_distribution(spec)
        # PyYAML (YAML 1.1) parses exponent-only floats like `1e-6` as
        # strings — the shipped sweep YAMLs use that form, so coerce.
        lo, hi = float(spec["min"]), float(spec["max"])
        if dist == "uniform":
            return float(self._rng.uniform(lo, hi))
        if dist == "log_uniform_values":
            return float(math.exp(self._rng.uniform(math.log(lo), math.log(hi))))
        return int(self._rng.integers(int(lo), int(hi) + 1))

    # -- TPE ---------------------------------------------------------------

    @classmethod
    def _continuous_space(cls, spec: dict[str, Any]) -> tuple | None:
        """(lo, hi, to_internal, from_internal) for a continuous/int spec, else None."""
        try:
            dist = cls._resolve_distribution(spec)
        except ValueError:
            return None
        lo, hi = float(spec["min"]), float(spec["max"])
        if dist == "log_uniform_values":
            return (
                math.log(lo),
                math.log(hi),
                math.log,
                lambda x: float(math.exp(x)),
            )
        if dist == "int_uniform":
            return lo, hi, float, lambda x: int(round(min(max(x, lo), hi)))
        return lo, hi, float, float

    def _tpe_continuous(self, spec: dict[str, Any], good: list[float], bad: list[float]) -> tuple | None:
        """Candidates + scorer for one continuous parameter (internal space)."""
        lo, hi, _, _ = self._continuous_space(spec)
        width = max(hi - lo, 1e-12)

        def bandwidth(pts):
            if len(pts) < 2:
                return width / 4.0
            bw = float(np.std(pts)) * len(pts) ** -0.2
            return max(bw, width / 20.0)

        def density(x, pts, bw):
            # Parzen mixture with a uniform-prior component: keeps a floor of
            # exploration mass everywhere in the range.
            kernel = np.exp(-0.5 * ((x[:, None] - np.asarray(pts)[None, :]) / bw) ** 2)
            kernel = kernel.sum(axis=1) / (bw * math.sqrt(2 * math.pi))
            return (kernel + 1.0 / width) / (len(pts) + 1.0)

        bw_g, bw_b = bandwidth(good), bandwidth(bad)
        # Draw candidates from the good model (prior component included).
        n = self._n_candidates
        picks = self._rng.integers(-1, len(good), size=n)
        cand = np.where(
            picks < 0,
            self._rng.uniform(lo, hi, size=n),
            np.asarray(good)[np.maximum(picks, 0)] + self._rng.normal(0.0, bw_g, size=n),
        )
        cand = np.clip(cand, lo, hi)
        score = np.log(density(cand, good, bw_g)) - np.log(density(cand, bad, bw_b))
        return cand, score

    def _tpe_categorical(self, spec: dict[str, Any], good: list, bad: list) -> tuple:
        values = spec["values"]

        def probs(obs):
            counts = np.array([sum(1 for o in obs if o == v) for v in values], float)
            counts += 1.0  # Laplace smoothing
            return counts / counts.sum()

        pg, pb = probs(good), probs(bad)
        n = self._n_candidates
        idx = self._rng.choice(len(values), size=n, p=pg)
        return idx, np.log(pg[idx]) - np.log(pb[idx])

    def _sample_tpe(self) -> dict[str, Any]:
        obs = self._observations
        n_good = max(1, int(self._gamma * len(obs)))
        ranked = sorted(obs, key=lambda cv: cv[1])
        good_cfgs = [c for c, _ in ranked[:n_good]]
        bad_cfgs = [c for c, _ in ranked[n_good:]] or good_cfgs

        # Independent per-parameter TPE; candidates are scored jointly and
        # the argmax column wins (all parameters' candidate i form one joint
        # candidate, so the winner maximizes the summed log-density ratio).
        joint_score = np.zeros(self._n_candidates)
        choices: dict[str, Any] = {}
        per_param: dict[str, tuple] = {}
        for name, spec in self.parameters.items():
            if "value" in spec:
                choices[name] = spec["value"]
                continue
            g = [c[name] for c in good_cfgs if name in c]
            b = [c[name] for c in bad_cfgs if name in c]
            if not g or not b:
                choices[name] = self._sample_one(spec)
                continue
            if "values" in spec:
                idx, score = self._tpe_categorical(spec, g, b)
                per_param[name] = ("cat", idx)
            else:
                space = self._continuous_space(spec)
                if space is None:
                    choices[name] = self._sample_one(spec)
                    continue
                to_internal, from_internal = space[2], space[3]
                cand, score = self._tpe_continuous(
                    spec, [to_internal(float(x)) for x in g], [to_internal(float(x)) for x in b]
                )
                per_param[name] = ("cont", cand, from_internal)
            joint_score += score
        best = int(np.argmax(joint_score))
        for name, entry in per_param.items():
            if entry[0] == "cat":
                choices[name] = self.parameters[name]["values"][int(entry[1][best])]
            else:
                choices[name] = entry[2](float(entry[1][best]))
        return choices

    # -- public API ---------------------------------------------------------

    def sample(self) -> dict[str, Any]:
        if self.method == "bayes" and len(self._observations) >= self._n_startup:
            return self._sample_tpe()
        return {name: self._sample_one(spec) for name, spec in self.parameters.items()}

    def next_trial_index(self) -> int:
        """First unused ``local-N`` trial index, scanned from the results log.

        Counting observations instead would undercount (failed trials and
        trials that never logged the target metric produce no observation),
        yielding duplicate run_ids across relaunches.
        """
        results_path = self.output_dir / "sweep_results.jsonl"
        last = -1
        if results_path.exists():
            for line in results_path.read_text().splitlines():
                try:
                    rid = json.loads(line).get("run_id", "")
                except json.JSONDecodeError:
                    continue
                if isinstance(rid, str) and rid.startswith("local-"):
                    try:
                        last = max(last, int(rid.split("-", 1)[1]))
                    except ValueError:
                        continue
        return last + 1

    def observe(self, config: dict[str, Any], value: float) -> None:
        """Feed a completed trial back to the Bayes sampler.

        ``value`` is the target metric as logged; orientation follows the
        sweep's ``metric.goal`` (maximize flips the sign internally).
        """
        if not math.isfinite(value):
            return
        oriented = -value if self.metric.get("goal") == "maximize" else value
        self._observations.append((dict(config), float(oriented)))
        self._state_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self._state_path, "a") as f:
            f.write(json.dumps({"config": dict(config), "value": float(oriented)}) + "\n")

    def agent(self, function: Any, count: int | None = None) -> None:
        """Run ``count`` trials (default 1), each inside a LocalRun context.

        Trial failures are isolated — a crashed trial logs its error and the
        agent continues, mirroring the W&B agent's per-run isolation that the
        reference relies on for sweep robustness. Under ``method: bayes``
        each trial's logged target metric (``metric.name``) feeds the TPE
        sampler for subsequent trials.
        """
        results_path = self.output_dir / "sweep_results.jsonl"
        metric_name = self.metric.get("name")
        failures = 0
        n_trials = 1 if count is None else count  # explicit 0 runs zero trials
        offset = self.next_trial_index()  # resumed sweeps continue numbering
        for trial in range(n_trials):
            run = LocalRun(f"local-{offset + trial}", {}, results_path)
            try:
                config = self.sample()
                run.config = _Config(config)
                # Claim the run_id on disk BEFORE training: a trial killed
                # mid-run (SIGKILL/OOM) otherwise leaves no record, and the
                # relaunch would reuse its id AND its resume-RNG position —
                # replaying the identical config under a duplicated run_id.
                run.log({"event": "trial_start", "config": config})
                with run:
                    function(run)
                if metric_name is not None and metric_name in run.summary:
                    self.observe(config, float(run.summary[metric_name]))
            except Exception as e:  # noqa: BLE001 - trial isolation
                failures += 1
                run.log({"error": f"{type(e).__name__}: {e}"})
        if n_trials and failures == n_trials:
            raise RuntimeError(f"All {failures} sweep trial(s) failed; see {results_path}")
