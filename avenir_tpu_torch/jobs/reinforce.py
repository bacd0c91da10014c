"""Bandit jobs — one round of arm selection per group over the reference's
``group,item,count,reward`` row format (reinforce/GreedyRandomBandit.java,
AuerDeterministic.java, SoftMaxBandit.java, RandomFirstGreedyBandit.java);
port of ``avenir_tpu/jobs/reinforce.py``.

An external loop (the tutorial's runbook, resource/price_optimize_tutorial.txt:
42-78) updates rewards between rounds and bumps ``current.round.num`` — the
same contract here, minus the cluster submit.  The selections run on the
job's device (``models/bandits.py``).
"""

from __future__ import annotations

from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.jobs.base import Job, read_input, write_output
from avenir_tpu_torch.models.bandits import BanditJob
from avenir_tpu_torch.utils.metrics import Counters


class _BanditRound(Job):
    algorithm = ""

    def _algorithm(self, conf: JobConfig) -> str:
        return self.algorithm

    def _kwargs(self, conf: JobConfig) -> dict:
        return {}

    def execute(self, conf: JobConfig, input_path: str, output_path: str,
                counters: Counters) -> None:
        delim = conf.field_delim_regex
        rows = read_input(input_path, delim=delim).tolist()
        job = BanditJob(self._algorithm(conf), seed=conf.get_int("seed", 0),
                        device=self.device, **self._kwargs(conf))
        round_num = conf.get_int("current.round.num", 1)
        lines = job.select_lines(rows, round_num, delim=conf.field_delim,
                                 count_ord=conf.get_int("count.ordinal", 2),
                                 reward_ord=conf.get_int("reward.ordinal", 3))
        write_output(output_path, lines)
        counters.set("Groups", "Selected", len(lines))
        counters.set("Round", "Number", round_num)


class GreedyRandomBandit(_BanditRound):
    """ε-greedy with linear / log-linear decay, plus the AuerGreedy variant
    (GreedyRandomBandit.java:196-274). ``prob.reduction.algorithm``:
    linear | loglinear | auer."""

    name = "GreedyRandomBandit"

    def _algorithm(self, conf: JobConfig) -> str:
        return {"linear": "greedyRandomLinear",
                "loglinear": "greedyRandomLogLinear",
                "logLinear": "greedyRandomLogLinear",
                "auer": "auerGreedy"}[
            conf.get("prob.reduction.algorithm", "linear")]

    def _kwargs(self, conf: JobConfig) -> dict:
        return dict(
            epsilon=conf.get_float("random.selection.prob", 1.0),
            prob_reduction_constant=conf.get_float("prob.reduction.constant", 1.0),
            auer_constant=conf.get_float("auer.greedy.constant", 5.0),
        )


class AuerDeterministic(_BanditRound):
    """UCB1 (AuerDeterministic.java:200-223)."""

    name = "AuerDeterministic"
    algorithm = "auerDeterministic"


class SoftMaxBandit(_BanditRound):
    """Boltzmann selection with temperature ``temp.constant``
    (SoftMaxBandit.java:182-198)."""

    name = "SoftMaxBandit"
    algorithm = "softMax"

    def _kwargs(self, conf: JobConfig) -> dict:
        return dict(tau=conf.get_float("temp.constant", 0.1))


class RandomFirstGreedyBandit(_BanditRound):
    """Explore-first: budget = factor·K or the PAC bound
    (RandomFirstGreedyBandit.java:138-147)."""

    name = "RandomFirstGreedyBandit"
    algorithm = "randomFirstGreedy"

    def _kwargs(self, conf: JobConfig) -> dict:
        return dict(
            strategy=conf.get("exploration.count.strategy", "simple"),
            exploration_count_factor=conf.get_int("exploration.count.factor", 3),
            reward_diff=conf.get_float("pac.reward.diff", 0.5),
            prob_diff=conf.get_float("pac.prob.diff", 0.1),
        )
