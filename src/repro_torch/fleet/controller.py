"""The port's copy of ``repro.fleet.controller``, unchanged in behaviour
(the port imports nothing of the reference package).

Online adaptive MPG controller (paper §5–§6, closed-loop).

The paper's central claim is that MPG is an *optimization* signal, not a
report: the per-layer waterfall tells a fleet operator which knob to turn
while the fleet is running.  The offline advisor
(``repro_torch.fleet.advisor``) ranks knobs after the fact by full
resimulation; this module closes the ROADMAP's loop with an
:class:`AdaptiveController` that reacts *during* the run:

  * it subscribes to the ledger's windowed SG/RG/PG series
    (:meth:`~repro_torch.core.ledger.GoodputLedger.tail_series`) and to a
    streaming :class:`~repro_torch.core.attribution.AttributionWaterfall`
    of its own (attached before the first event, like a trace recorder);
  * at decision boundaries — every ``windows_per_decision`` ledger windows
    — it reduces the observation deltas to a :class:`Signals` row and asks
    its rule table for an :class:`Action`;
  * accepted actions switch the live sim's placement/preemption/defrag
    policy objects (:meth:`FleetSim.set_policies`), toggle the fleet-wide
    elastic-resize override, and retune every pending job's Daly
    checkpoint interval from the *observed* failure rate;
  * hysteresis (distinct enter/exit thresholds + a consecutive-calm exit
    count) and a hard cooldown prevent thrashing: at most one switch per
    ``cooldown_s``, enforced structurally in :meth:`_consider`;
  * every accepted switch emits a ``Phase.CONTROL`` scheduling-layer
    interval, so the cost of control is itself a visible waterfall bucket
    (``policy_switch``).

Determinism contract: a decision consumes only state that is bit-for-bit
identical across engines — integer counters (failures, queue and gang
membership), the waterfall's exact cells, and the ledger's windowed
accumulators — and the vectorized engine flushes its columnar buffers
before every observation (``FleetSim._control_sync``), so a controlled
run produces identical ``ledger.totals()`` on both engines.

The rule table is the deliverable, but the hook is policy-shaped: any
object with ``propose(signals, mode) -> Optional[Action]`` (a learned
policy, a bandit, a schedule) drops into ``AdaptiveController(rules=...)``
unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.attribution import AttributionWaterfall
from repro_torch.core.goodput import Layer, Phase
from repro_torch.fleet.policies import PAPER_COMBO

CONTROL_JOB_ID = "__controller__"


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Decision cadence, hysteresis thresholds, and switch costs."""
    windows_per_decision: int = 1     # decision boundary every K windows
    cooldown_s: float = 2 * 3600.0    # hard floor between accepted switches
    # survival-mode entry (any one suffices; see RuleTable.propose).  The
    # failure trigger is scale-aware: a boundary is a storm when its
    # failure count reaches ``storm_rate_x`` times the fleet's *nominal*
    # expectation (chips * period / chip_mtbf), floored at
    # ``storm_failures`` so a tiny fleet's nominal-0.004 expectation
    # doesn't make every single failure a storm
    storm_failures: int = 2           # absolute floor, failures per period
    storm_rate_x: float = 3.0         # x nominal expected failures/period
    storm_rollback_frac: float = 0.20   # rollback+stall loss / period cap
    # survival-mode exit hysteresis: a boundary only counts as calm below
    # the (much lower) off-threshold, `calm_boundaries` consecutive calm
    # boundaries are required before restoring baseline, and the exit is
    # vetoed outright while the *cumulative* observed failure rate stays
    # above ``calm_rate_x`` times nominal — a fleet whose MTBF is
    # genuinely degraded (an adversarial mtbf_factor shock) never looks
    # calm, no matter how quiet one night is
    calm_rollback_frac: float = 0.01
    calm_boundaries: int = 2
    calm_rate_x: float = 1.5
    # scheduler-rescue rule: sustained queue overhang under non-paper
    # policies switches the live policy objects to the paper combo
    rescue_queue_frac: float = 0.50   # queued chip demand / fleet chips
    rescue_boundaries: int = 2
    # accounting cost of one switch (the Phase.CONTROL interval)
    switch_cost_s: float = 120.0
    switch_chips: int = 1
    # Daly retune: observed-failure evidence floor before trusting the
    # empirical MTBF estimate
    min_failures_for_retune: int = 2
    # correlated-burst detector (stricter than the storm trigger): a
    # boundary whose failure count is this far above nominal is a
    # mass-kill event, not background hazard — its failures are excluded
    # from the background-MTBF evidence, and once one has been seen the
    # retune stops lengthening intervals (Daly's exponential model says
    # nothing about the next correlated kill).  A Poisson pair on a calm
    # fleet can reach the storm floor but not this one
    burst_failures: int = 3           # absolute floor, failures per period
    burst_rate_x: float = 10.0        # x nominal expected failures/period

    def __post_init__(self):
        if self.windows_per_decision < 1:
            raise ValueError(f"windows_per_decision must be >= 1, "
                             f"got {self.windows_per_decision}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, "
                             f"got {self.cooldown_s}")
        if not self.calm_rollback_frac < self.storm_rollback_frac:
            raise ValueError(
                "hysteresis needs calm_rollback_frac < storm_rollback_frac, "
                f"got {self.calm_rollback_frac} vs {self.storm_rollback_frac}")


@dataclasses.dataclass(frozen=True)
class Signals:
    """One decision boundary's observations.  Every field derives from
    engine-identical state (integer counters, exact waterfall cells,
    windowed ledger accumulators), so the same rule table makes the same
    decisions on both engines."""
    t: float
    failures_delta: int           # fleet failures since the last boundary
    expected_failures: float      # nominal per-boundary expectation:
                                  # chips * period / chip_mtbf
    cum_rate_x: float             # cumulative observed failure rate over
                                  # the run, as a multiple of nominal
                                  # (0.0 until there is enough evidence)
    rollback_frac: float          # (failure_rollback + gang_stall) delta
                                  # over the period's capacity chip-time
    gang_waiting: int             # rigid gangs stalled on replacement HW
    maintenance: bool             # any pod currently drained
    queue_frac: float             # queued chip demand / fleet chips
    paper_policies: bool          # live policies == the paper combo
    sg: float                     # last ledger window's scheduling goodput
    mpg: float                    # last ledger window's MPG


@dataclasses.dataclass(frozen=True)
class Action:
    """One accepted switch.  ``mode`` is the controller mode to enter
    (None keeps the current one); ``elastic_override`` feeds
    ``FleetSim._elastic_override`` verbatim (``"keep"`` leaves it)."""
    rule: str
    mode: Optional[str] = None
    elastic_override: object = "keep"
    retune_daly: bool = False
    policies: Optional[Dict[str, str]] = None
    evict_gang_waits: bool = False


class RuleTable:
    """The deliverable: Signals -> Optional[Action], with hysteresis.

    Four rules, in precedence order:

      * **scheduler_rescue** — sustained queue overhang while running
        non-paper policies: switch the live policy objects to the paper
        combo (placement/preemption/defrag all at once);
      * **survival entry** — a failure storm (scale-aware failure-count
        trigger or rollback-loss fraction over threshold) or an active
        maintenance drain: force elastic resize on, retune Daly intervals
        from the observed failure rate, and evict stalled rigid gangs so
        they requeue elastically;
      * **gang_rescue** — outside survival, a rigid gang stalled on a
        repair window: evict it (freeing the healthy slices' chips for
        the backlog) and retune, *without* flipping the whole fleet
        elastic — one stuck gang is a local problem, not a storm;
      * **calm restore** — `calm_boundaries` consecutive boundaries below
        the (lower) exit thresholds, and a cumulative failure rate back
        near nominal: restore per-job elastic flags.

    A learned policy replaces this class wholesale — the contract is just
    ``propose(signals, mode)``.
    """

    def __init__(self, cfg: ControllerConfig):
        self.cfg = cfg
        self._calm_streak = 0
        self._queue_streak = 0

    def _storm(self, s: Signals) -> bool:
        cfg = self.cfg
        threshold = max(float(cfg.storm_failures),
                        cfg.storm_rate_x * s.expected_failures)
        return (s.failures_delta >= threshold
                or s.rollback_frac >= cfg.storm_rollback_frac)

    def propose(self, s: Signals, mode: str) -> Optional[Action]:
        cfg = self.cfg
        if not s.paper_policies and s.queue_frac >= cfg.rescue_queue_frac:
            self._queue_streak += 1
            if self._queue_streak >= cfg.rescue_boundaries:
                self._queue_streak = 0
                return Action(rule="scheduler_rescue",
                              policies=dict(PAPER_COMBO))
        else:
            self._queue_streak = 0
        if mode != "survival":
            if self._storm(s) or s.maintenance:
                self._calm_streak = 0
                rule = ("maintenance_drain"
                        if s.maintenance and not self._storm(s)
                        else "failure_storm")
                # the fleet-wide elastic flip helps when failures are the
                # dominant pressure (degraded restarts beat queueing for
                # full shapes), but during a capacity drain it makes jobs
                # squeeze into the shrunken fleet at tiny widths and pay
                # reshard churn twice — once in, once back out — so a
                # storm that arrives mid-drain rides out rigid, with
                # gang eviction + Daly retune only
                flip = True if not s.maintenance else "keep"
                return Action(rule=rule, mode="survival",
                              elastic_override=flip, retune_daly=True,
                              evict_gang_waits=True)
            if s.gang_waiting > 0:
                return Action(rule="gang_rescue", retune_daly=True,
                              evict_gang_waits=True)
            return None
        calm = (s.failures_delta == 0
                and s.rollback_frac <= cfg.calm_rollback_frac
                and s.gang_waiting == 0
                and not s.maintenance
                and s.cum_rate_x <= cfg.calm_rate_x)
        self._calm_streak = self._calm_streak + 1 if calm else 0
        if self._calm_streak >= cfg.calm_boundaries:
            self._calm_streak = 0
            return Action(rule="calm_restore", mode="baseline",
                          elastic_override=None)
        return None


class AdaptiveController:
    """Online closed-loop controller over a live :class:`FleetSim`.

    Usage (or just pass ``controller=`` to ``scenarios.build_sim``)::

        ctrl = AdaptiveController()
        sim = build_sim(scenario, ..., controller=ctrl)
        sim.run()
        ctrl.switches        # the decision log
    """

    def __init__(self, cfg: Optional[ControllerConfig] = None, rules=None):
        self.cfg = cfg if cfg is not None else ControllerConfig()
        self.rules = rules if rules is not None else RuleTable(self.cfg)
        self.mode = "baseline"
        self.switches: List[dict] = []
        self.waterfall: Optional[AttributionWaterfall] = None
        self.decide_every_s: float = 0.0
        self._sim = None
        self._last_switch_t = -math.inf
        self._prev_failures = 0
        self._prev_buckets: Dict[str, float] = {}
        # background-MTBF evidence: failures and allocated chip-time
        # accumulated over non-burst boundaries.  Correlated mass-kill
        # boundaries are excluded so a burst cannot poison the Daly
        # estimate — a fleet with healthy background MTBF that eats one
        # burst should not start checkpointing 3x as often for the rest
        # of the run.  Mild storm boundaries (a Poisson pair) DO count:
        # they are background hazard, and dropping them would bias the
        # estimate toward a healthier fleet than the one observed
        self._bg_failures = 0
        self._bg_alloc = 0.0
        self._prev_alloc = 0.0
        self._burst_seen = False

    # ---- binding ----------------------------------------------------------
    def bind(self, sim) -> "AdaptiveController":
        """Attach to ``sim`` before it runs: subscribe a fresh waterfall
        (must precede the first emitted event) and schedule the first
        decision boundary."""
        if self._sim is not None:
            raise ValueError("controller is already bound to a sim")
        self._sim = sim
        self.decide_every_s = (self.cfg.windows_per_decision
                               * sim.ledger.window)
        if self.decide_every_s <= 0:
            raise ValueError(
                "controller needs a positive ledger window to define its "
                f"decision cadence, got window={sim.ledger.window!r}")
        self.waterfall = AttributionWaterfall().attach(sim.ledger)
        sim.attach_controller(self)
        return self

    # ---- decision boundary ------------------------------------------------
    def on_boundary(self, sim) -> None:
        """One decision boundary (the sim calls this on every timed
        ``control`` event, after its engine-specific ledger sync)."""
        s = self._signals(sim)
        action = self._consider(s)
        if action is not None:
            self._apply(sim, action, s)
        # background-MTBF bookkeeping: correlated mass-kill boundaries
        # never enter the Daly evidence.  The burst predicate is
        # recomputed from cfg (not delegated to the rule table) so a
        # learned `rules` plug-in can't poison it
        cfg = self.cfg
        correlated = (s.failures_delta
                      >= max(float(cfg.burst_failures),
                             cfg.burst_rate_x * s.expected_failures))
        alloc = sim.ledger._totals.allocated
        if correlated:
            self._burst_seen = True
        else:
            self._bg_failures += s.failures_delta
            self._bg_alloc += alloc - self._prev_alloc
        self._prev_alloc = alloc
        self._prev_failures += s.failures_delta
        self._prev_buckets = self.waterfall.bucket_totals()

    def _signals(self, sim) -> "Signals":
        failures = sum(rt.failures for rt in sim.jobs.values())
        buckets = self.waterfall.bucket_totals()
        prev = self._prev_buckets

        def delta(name: str) -> float:
            return buckets.get(name, 0.0) - prev.get(name, 0.0)

        total_chips = sim.cluster.total_chips
        period_cap = total_chips * self.decide_every_s
        rollback_frac = ((delta("failure_rollback") + delta("gang_stall"))
                         / period_cap if period_cap else 0.0)
        queue_chips = sum(sim.jobs[j].spec.chips for j in sim.queue)
        rows = sim.ledger.tail_series(1, total_chips)
        last = rows[-1] if rows else {"sg": 0.0, "mpg": 0.0}
        paper = (sim.placement.name == PAPER_COMBO["placement"]
                 and sim.preemption.name == PAPER_COMBO["preemption"]
                 and sim.defrag.name == PAPER_COMBO["defrag"])
        # nominal rates come from the fleet's *spec* MTBF (SimConfig),
        # not the scenario's shock factor — the controller must infer a
        # degraded fleet from observations, not read the ground truth.
        # The cumulative comparison normalizes by *allocated* chip-time
        # (failures only strike running jobs), so low occupancy doesn't
        # read as a healthy MTBF
        expected = total_chips * self.decide_every_s / sim.cfg.chip_mtbf
        cum_rate_x = 0.0
        if failures >= self.cfg.min_failures_for_retune:
            nominal_cum = sim.ledger._totals.allocated / sim.cfg.chip_mtbf
            cum_rate_x = failures / nominal_cum if nominal_cum else 0.0
        return Signals(
            t=sim.now,
            failures_delta=failures - self._prev_failures,
            expected_failures=expected,
            cum_rate_x=cum_rate_x,
            rollback_frac=rollback_frac,
            gang_waiting=len(sim._gang_wait),
            maintenance=any(d > 0 for d in sim._maint_depth.values()),
            queue_frac=queue_chips / total_chips if total_chips else 0.0,
            paper_policies=paper,
            sg=last["sg"], mpg=last["mpg"])

    def _consider(self, s: "Signals") -> Optional[Action]:
        """Cooldown + rule table: the pure decision core (the hypothesis
        safety properties drive this method with synthetic Signals).  A
        boundary inside the cooldown proposes nothing — at most one
        accepted switch per ``cooldown_s``, structurally."""
        if s.t - self._last_switch_t < self.cfg.cooldown_s:
            return None
        action = self.rules.propose(s, self.mode)
        if action is None:
            return None
        self._last_switch_t = s.t
        if action.mode is not None:
            self.mode = action.mode
        self.switches.append({
            "t": s.t, "rule": action.rule, "mode": self.mode,
            "signals": {"failures_delta": s.failures_delta,
                        "rollback_frac": s.rollback_frac,
                        "gang_waiting": s.gang_waiting,
                        "maintenance": s.maintenance,
                        "queue_frac": s.queue_frac,
                        "sg": s.sg, "mpg": s.mpg},
        })
        return action

    # ---- action application ----------------------------------------------
    def _apply(self, sim, action: Action, s: "Signals") -> None:
        # the switch-overhead interval is emitted FIRST: the vectorized
        # engine's buffers are empty right after _control_sync, so a
        # direct ledger emit here lands in the same stream position on
        # both engines; action side-effects below may emit (buffered)
        cost = min(s.t + self.cfg.switch_cost_s, sim.cfg.horizon)
        sim.ledger.emit(
            job_id=CONTROL_JOB_ID, phase=Phase.CONTROL, t0=s.t, t1=cost,
            chips=self.cfg.switch_chips,
            segment={"layer": Layer.SCHEDULING.value,
                     "emitter": "controller", "rule": action.rule})
        if action.policies:
            sim.set_policies(**action.policies)
        if action.elastic_override != "keep":
            sim._elastic_override = action.elastic_override
        retuned = 0
        if action.retune_daly:
            retuned = self._retune_daly(sim, s)
        if action.evict_gang_waits and sim._gang_wait:
            for job_id in list(sim._gang_wait):
                sim._evict_gang_wait(job_id)
            sim._try_schedule()
        self.switches[-1]["retuned_jobs"] = retuned

    def _retune_daly(self, sim, s: "Signals") -> int:
        """Re-derive pending jobs' checkpoint intervals from the observed
        fleet failure rate (Daly's sqrt(2 * write * MTBF), the advisor's
        formula fed by live evidence instead of the configured MTBF).
        Only jobs with no open run segment are touched — an open segment's
        checkpoint-survival accounting reads the spec it started with.

        The MTBF estimate uses *background* evidence only (failures and
        allocated chip-time from non-burst boundaries): correlated
        mass-kill bursts say nothing about the exponential background
        rate Daly's formula models, and counting them shrinks intervals
        ~3x on a healthy fleet.  Direction is burst-gated: on a fleet
        that has never shown a correlated burst the retune moves freely
        toward the Daly optimum (lengthening a miscalibrated
        too-frequent interval is a pure overhead win there), but once
        one mass-kill boundary has been seen it only ever *shortens* —
        the configured interval is the operator's prior on correlated
        risk, and lengthening it on "healthy background" evidence walks
        straight into the next burst."""
        if (self._bg_failures < self.cfg.min_failures_for_retune
                or self._bg_alloc <= 0):
            return 0
        chip_mtbf_obs = self._bg_alloc / self._bg_failures
        retuned = 0
        for job_id, rt in sim.jobs.items():
            if job_id in sim.running or rt.remaining <= 0:
                continue
            spec = rt.spec
            write = (sim.cfg.async_snapshot_pause if spec.async_checkpoint
                     else spec.checkpoint_write)
            mtbf = chip_mtbf_obs / spec.chips
            cap = (spec.checkpoint_interval if self._burst_seen
                   else 86400.0)
            interval = max(60.0, min(cap, math.sqrt(2.0 * write * mtbf)))
            if interval != spec.checkpoint_interval:
                rt.spec = dataclasses.replace(
                    spec, checkpoint_interval=interval)
                retuned += 1
        return retuned
