"""Simulation configuration — the port's own copy of the JAX package's
`utils/config.py`, kept field-for-field identical (tests/test_torch_state.py
holds `dataclasses.asdict` of both equal) so one config dict drives either
package. The comments describe the whole system; the port runs the subset
`ops/tick.make_flags` accepts and raises NotImplementedError on the rest.

The reference hard-codes every pacing constant (see BASELINE.md); here they are the
defaults of a frozen dataclass, expressed in simulation ticks (1 tick = 100 ms of
reference wall-time). Sources: election timeout 20_000..23_000 ms
(reference Commons.kt:23), heartbeat period 2_000 ms (RaftServer.kt:115), vote-round
window 25 s (RaftServer.kt:189,214), vote retry 5_000 ms (Commons.kt:37), candidate
backoff 2_000..3_000 ms (RaftServer.kt:221).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Canonical partition-program kind codes (utils/rng.scenario_link_down —
# shared verbatim by kernel aux assembly, Python oracle and native engine).
PART_NONE, PART_SPLIT, PART_ASYM, PART_LEADER = 0, 1, 2, 3
PART_KINDS = ("split", "asym", "leader")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Per-group scenario heterogeneity (the fuzzing-farm bank, SEMANTICS.md
    §12). When `RaftConfig.scenario` is set, `ops/tick.make_rng` samples a
    ScenarioBank — per-group fault thresholds, delay windows and partition
    programs — from a counted threefry stream keyed by
    (farm_seed, universe_id = universe_base + group), so every group is a
    distinct, reproducible universe and the bank rides the rng operand
    (seed- and universe-independent compilation). The spec itself is static
    and hashable: it is part of the config, so a replay artifact is just
    the config dict.

    Channels (each sampled per group, uniform over its integer domain):
    - drop/crash/restart/link_fail/link_heal: per-group 23-bit uint32
      probability thresholds on [0, p_threshold(<ch>_max)] (utils/rng —
      integer-exact across oracle and kernels; <ch>_max = 0 disables).
    - delay_windows: per-group [lo, hi] delay windows sampled WITHIN the
      run's mailbox window [delay_lo, delay_hi] (requires delay_lo <
      delay_hi; the run's regime — known-delivery etc. — is preserved).
    - partitions: the enabled scripted partition-program kinds, a subset
      of PART_KINDS; each group draws one program (or none) with
      flapping window (period, duty, phase) — see utils/rng.
      "leader" programs read the PRE-TICK roles, so they are unavailable
      to engines whose aux is precomputed ahead of state (the fused-T
      Pallas kernel falls back to T=1; everything else works).

    `warmup_down` (§15, SEMANTICS.md) is NOT a sampled channel but a
    deterministic schedule post-processed onto the crash/restart masks
    (utils/rng.apply_warmup_faults — no draws consumed): every non-cmd
    node is held crashed for t < warmup_down and rejoins at t ==
    warmup_down, so cmd_node wins every group's first election and a
    compaction universe stays capacity-clean at any group count.

    `degenerate=True` is the provable degenerate case: the bank is built
    from the config's own SCALAR fault fields (all groups identical), and
    every engine must be bit-identical to the scalar path — the farm's
    correctness anchor (tests/test_fuzz.py)."""

    farm_seed: int = 0
    universe_base: int = 0
    degenerate: bool = False
    drop_max: float = 0.0
    crash_max: float = 0.0
    restart_max: float = 0.0
    link_fail_max: float = 0.0
    link_heal_max: float = 0.0
    delay_windows: bool = False
    partitions: tuple = ()
    part_period_lo: int = 8
    part_period_hi: int = 64
    # §15 warmup-down (SEMANTICS.md §15): for warmup_down = W > 0, every
    # node except cfg.cmd_node is held crashed on ticks t < W (crash
    # asserted, random restarts suppressed) and restarted at exactly
    # t == W. Deterministic — no draws consumed — so all engines apply
    # the identical rule (utils/rng.apply_warmup_faults). Because quirk k
    # routes every client command to cmd_node, this makes cmd_node win
    # each group's first election by term + log dominance: the one
    # universe family whose committed prefix keeps pace with the client
    # in EVERY group, which a bounded §15 ring needs to stay
    # capacity-clean at any group count.
    warmup_down: int = 0
    # §19 continuous-scheduler channels (SEMANTICS.md §19):
    # - timeout_windows: sample a per-group election-timeout window
    #   [el_lo, el_hi] nested inside the config's window (the §9.3 timing
    #   observatory's spread channel). Engines that bake scalar el bounds
    #   (Pallas, oracle, native) refuse such banks loudly.
    # - life_lo/life_hi: per-group lifetime in ticks — the horizon-reached
    #   arm of the retirement predicate (life_hi = 0 disables).
    # - quiesce_ticks: retire a group after this many consecutive calm
    #   ticks (live leader, no election activity, no fault transitions);
    #   0 disables. Static (not sampled): part of the retire predicate
    #   compiled into the monitor carry, not a bank channel.
    timeout_windows: bool = False
    life_lo: int = 0
    life_hi: int = 0
    quiesce_ticks: int = 0
    # §20 client-stream channels (SEMANTICS.md §20): the serving path's
    # device-resident load generator samples per-group workload shape —
    # write rate, read rate, and key skew — as bank rows, evaluated via
    # the §17 kernel-twin draws (bit-identical in-scan and host-eager;
    # the device-generator ≡ host-queue equality theorem rides on it).
    # - client_rate_max: per-group writes/tick drawn uniform in
    #   [1, client_rate_max] (0 disables the channel; the run then uses
    #   the classical cmd_period workload).
    # - client_read_max: per-group reads/tick drawn uniform in
    #   [1, client_read_max] (0 disables; cfg.read_batch applies).
    # - client_hot_max: per-group hot-key weight in permille, drawn
    #   uniform in [0, client_hot_max] — the drawn fraction of reads and
    #   writes lands on slot 0, the rest uniform over the KV slots.
    client_rate_max: int = 0
    client_read_max: int = 0
    client_hot_max: int = 0

    def __post_init__(self):
        # Coerce to tuple so a list argument cannot build an unhashable
        # "frozen" spec (lru_cache keys on the whole config downstream).
        object.__setattr__(self, "partitions", tuple(self.partitions))
        for ch in ("drop", "crash", "restart", "link_fail", "link_heal"):
            p = getattr(self, f"{ch}_max")
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"{ch}_max must be in [0, 1], got {p}")
        bad = [k for k in self.partitions if k not in PART_KINDS]
        if bad:
            raise ValueError(f"unknown partition kinds {bad}; "
                             f"valid: {PART_KINDS}")
        if not (1 <= self.part_period_lo <= self.part_period_hi):
            raise ValueError(
                f"need 1 <= part_period_lo <= part_period_hi, got "
                f"{self.part_period_lo}/{self.part_period_hi}")
        if self.warmup_down < 0:
            raise ValueError(
                f"warmup_down must be >= 0, got {self.warmup_down}")
        if self.warmup_down > 0 and self.degenerate:
            raise ValueError(
                "warmup_down is a scheduled fault program — it cannot ride "
                "a degenerate (scalar-anchor) spec")
        if not (0 <= self.life_lo <= self.life_hi):
            raise ValueError(
                f"need 0 <= life_lo <= life_hi, got "
                f"{self.life_lo}/{self.life_hi}")
        if self.life_hi > 0 and self.life_lo < 1:
            raise ValueError("life_lo must be >= 1 when lifetimes are on")
        if self.quiesce_ticks < 0:
            raise ValueError(
                f"quiesce_ticks must be >= 0, got {self.quiesce_ticks}")
        if self.degenerate and (self.timeout_windows or self.life_hi > 0):
            raise ValueError(
                "timeout_windows/lifetimes are sampled channels — they "
                "cannot ride a degenerate (scalar-anchor) spec")
        for ch in ("client_rate_max", "client_read_max", "client_hot_max"):
            if getattr(self, ch) < 0:
                raise ValueError(f"{ch} must be >= 0, got {getattr(self, ch)}")
        if self.client_hot_max > 1000:
            raise ValueError(
                f"client_hot_max is permille, must be <= 1000, got "
                f"{self.client_hot_max}")
        if self.degenerate and self.has_clients:
            raise ValueError(
                "client-stream channels are sampled — they cannot ride a "
                "degenerate (scalar-anchor) spec")

    @property
    def has_faults(self) -> bool:
        """Whether the sampled bank carries crash/restart channels or the
        §15 warmup-down schedule (the phase-F faults flag must compile
        in)."""
        return self.warmup_down > 0 or (not self.degenerate and (
            self.crash_max > 0 or self.restart_max > 0))

    @property
    def has_links(self) -> bool:
        """Whether the sampled bank carries link fail/heal channels (the
        phase-F link-transition flag must compile in)."""
        return not self.degenerate and (
            self.link_fail_max > 0 or self.link_heal_max > 0)

    @property
    def needs_state(self) -> bool:
        """Whether per-tick aux assembly must read pre-tick STATE (leader
        isolation) — engines that precompute aux ahead of state (the fused
        Pallas kernel) cannot run such banks and fall back."""
        return (not self.degenerate) and ("leader" in self.partitions)

    @property
    def has_clients(self) -> bool:
        """Whether the bank carries §20 client-stream channels (the
        serving path's device-resident load generator)."""
        return (self.client_rate_max > 0 or self.client_read_max > 0
                or self.client_hot_max > 0)


def config_from_dict(d: dict) -> "RaftConfig":
    """Rebuild a RaftConfig from dataclasses.asdict output (the triage /
    fuzz-corpus replay path): the nested scenario dict becomes a
    ScenarioSpec again and JSON-roundtripped lists re-tuple."""
    d = dict(d)
    scen = d.get("scenario")
    if isinstance(scen, dict):
        scen = dict(scen)
        if "partitions" in scen:
            scen["partitions"] = tuple(scen["partitions"])
        d["scenario"] = ScenarioSpec(**scen)
    return RaftConfig(**d)


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Static configuration for one simulation (shared by oracle and TPU kernel)."""

    n_groups: int = 1
    n_nodes: int = 3
    log_capacity: int = 64

    # Storage dtype of the log arrays (log_term/log_cmd): "int32" (default) or
    # "int16" — the deep-log lever (BASELINE config 5: 100k groups x 7 nodes x
    # 10k-entry logs = 28 GB of int32 terms; int16 halves it, SURVEY.md:350-352).
    # All arithmetic stays int32: values widen at read, narrow at write —
    # VALUES ARE NOT RANGE-CHECKED; writes outside int16 silently wrap. int16
    # is for bounded headless sweeps where both stored quantities fit:
    # terms < 32768 (terms grow ~1 per election round; at reference-ratio
    # pacing that is >700k ticks, but a degenerate churn config gets there in
    # ~65k) and commands < 32768 (the cmd_period workload stores the tick
    # index, so runs must stay under 32768 ticks). The Simulator API accepts
    # int16 with a BOUNDED vocabulary: interned ids live in [1<<14, 2^15)
    # (api/simulator.INTERN_BASE16, capacity-checked), which additionally
    # bounds cmd_period runs to < 16384 ticks for unambiguous de-interning.
    log_dtype: str = "int32"

    # Pacing, in ticks. Inclusive uniform ranges match Kotlin's (a..b).random().
    el_lo: int = 200          # election timeout lower bound
    el_hi: int = 230          # election timeout upper bound (inclusive)
    hb_ticks: int = 20        # heartbeat / replication period
    round_ticks: int = 250    # vote-round window (the 25 s latch)
    retry_ticks: int = 50     # vote RPC retry period within a round
    bo_lo: int = 20           # candidate backoff lower bound
    bo_hi: int = 30           # candidate backoff upper bound (inclusive)

    # Workload: every cmd_period ticks (if > 0), inject command value = tick index
    # into node cmd_node of every group (reference: GET /cmd/{command} on any node,
    # RaftServer.kt:87-90 — no leader check).
    cmd_period: int = 0
    cmd_node: int = 1

    # Fault injection (SEMANTICS.md §§4, 9). p_drop: per-tick iid drop probability per
    # directed edge. p_crash/p_restart: per-tick process crash / rejoin probability per
    # node (restart wipes all node state — reference quirk l, RaftServer.kt:35-48).
    # p_link_fail/p_link_heal: per-tick transition probabilities of the persistent
    # directed-link health mask (partitions).
    p_drop: float = 0.0
    p_crash: float = 0.0
    p_restart: float = 0.0
    p_link_fail: float = 0.0
    p_link_heal: float = 0.0

    # Message latency (SEMANTICS.md §10): per-exchange request delay drawn uniform
    # [delay_lo, delay_hi] ticks inclusive (per directed pair per send tick). 0/0 =
    # synchronous-within-tick exchanges (§1 [canon], the default — reference RPCs
    # are ms-scale against 100 ms ticks). `mailbox=True` forces the mailbox
    # implementation even at delay 0/0 (bit-identical to the synchronous path —
    # the τ=0 degeneracy differential tests rely on it).
    delay_lo: int = 0
    delay_hi: int = 0
    mailbox: bool = False

    # §15 log compaction / snapshotting (Raft §7; SEMANTICS.md §15).
    # compact_watermark W > 0 enables the subsystem: each tick (phase C),
    # every live node whose unfolded committed backlog commit - snap_index
    # reaches W folds up to compact_chunk oldest committed entries into
    # its fixed-shape snapshot (snap_index/snap_term/snap_digest) and
    # slides the ring window (ring base == snap_index). W = 0 (default)
    # compiles the subsystem OUT — the pre-§15 program, bit-identical
    # (the migration-equality contract, tests/test_compaction.py).
    compact_watermark: int = 0
    compact_chunk: int = 8

    # §16 physical ring window. ring_capacity C_phys < C
    # decouples log STORAGE from logical capacity: under compaction the
    # log arrays (and every position-indexed plane the engines derive
    # from them) allocate (N, C_phys, G) while logical positions stay
    # unbounded i32 and the §15 translate-or-latch map goes mod C_phys.
    # Requires compact_watermark > 0 (without folds nothing reclaims
    # ring rows) and C_phys >= watermark + chunk (the fold must always
    # have room to make progress before the window fills). The existing
    # cap_ov latch is the loud-fail when a group's backlog outruns the
    # physical window. None (default) keeps the physical window ==
    # log_capacity — the bit-identical pre-§16 program.
    ring_capacity: Optional[int] = None

    # §20 serving path (SEMANTICS.md §20). serve_slots S > 0 enables the
    # applied KV state machine: a fixed-slot (S, G) store folded from the
    # committed prefix as an end-of-tick apply phase (slot = cmd mod S),
    # advanced as a carry-resident observer in every engine — bit-neutral
    # to the protocol state, exactly like the recorder/monitor. S = 0
    # (default) compiles the subsystem OUT: the pre-§20 program,
    # bit-identical (the migration-equality contract every dimension
    # follows).
    serve_slots: int = 0
    # Apply-phase budget: at most apply_chunk committed entries fold into
    # the KV store per group per tick (fixed iteration count — the same
    # bounded-progress shape as §15 compact_chunk).
    apply_chunk: int = 4
    # Log-free linearizable reads (Raft §6.4 / §8): read_batch reads per
    # group per tick when no bank read channel overrides it; read_path
    # picks the confirmation rule — "readindex" (commit-frontier
    # confirmation, served at a live leader: +2 ticks submit→serve) or
    # "lease" (heartbeat-lease read at an armed leader: +1 tick). The
    # read path is a routed plan dimension (parallel/autotune.py).
    read_batch: int = 0
    read_path: str = "readindex"

    # §21 streaming ops plane (SEMANTICS.md §21). series_windows W > 0
    # enables the carry-resident multi-channel TIME-SERIES ring: a fixed
    # (W, K) int32 block in the monitor carry sampled every series_stride
    # ticks (0 = auto: the stride tiles the run exactly like the history
    # ring), one column per telemetry.SERIES_CHANNELS entry. event_capacity
    # E > 0 enables the bounded EVENT ring: the first E encoded
    # (kind, tick, group, arg) events of the run, with a loud
    # events_dropped counter once full. Both are pre/post-tick state
    # reductions riding the monitor carry — bit-neutral and engine-
    # independent by the same contract as the recorder/monitor, and 0
    # (default) compiles them OUT: the pre-§21 carry, bit-identical.
    series_windows: int = 0
    series_stride: int = 0
    event_capacity: int = 0

    seed: int = 0

    # Per-group scenario heterogeneity (the fuzzing-farm bank, SEMANTICS.md
    # §12): None = the classical single-universe run. When set, make_rng
    # samples the per-group ScenarioBank and threads it through every
    # engine's rng operand; the scalar fault fields above still apply as
    # baselines for any channel the spec does not sample.
    scenario: Optional[ScenarioSpec] = None

    def __post_init__(self):
        if not (0 <= self.delay_lo <= self.delay_hi):
            raise ValueError(
                f"need 0 <= delay_lo <= delay_hi, got {self.delay_lo}/{self.delay_hi}")
        if self.log_dtype not in ("int32", "int16"):
            raise ValueError(f"log_dtype must be int32 or int16, got {self.log_dtype}")
        if self.compact_watermark < 0:
            raise ValueError(
                f"compact_watermark must be >= 0, got {self.compact_watermark}")
        if self.compact_watermark > 0:
            if self.compact_chunk < 1:
                raise ValueError(
                    f"compact_chunk must be >= 1, got {self.compact_chunk}")
            if self.compact_watermark > self.log_capacity:
                raise ValueError(
                    "compact_watermark must be <= log_capacity (a window "
                    "that can never fold cannot bound the log)")
        if self.ring_capacity is not None:
            if self.compact_watermark <= 0:
                raise ValueError(
                    "ring_capacity needs compact_watermark > 0 — without "
                    "folds nothing ever reclaims physical ring rows")
            if self.ring_capacity < self.compact_watermark + self.compact_chunk:
                raise ValueError(
                    f"ring_capacity {self.ring_capacity} must be >= "
                    f"compact_watermark + compact_chunk "
                    f"({self.compact_watermark} + {self.compact_chunk}): the "
                    "fold must fit the window it is reclaiming")
            if self.ring_capacity > self.log_capacity:
                raise ValueError(
                    f"ring_capacity {self.ring_capacity} must be <= "
                    f"log_capacity {self.log_capacity} (the physical window "
                    "bounds storage, never extends it)")
        if self.serve_slots < 0:
            raise ValueError(
                f"serve_slots must be >= 0, got {self.serve_slots}")
        if self.serve_slots > 0:
            if self.apply_chunk < 1:
                raise ValueError(
                    f"apply_chunk must be >= 1, got {self.apply_chunk}")
            if self.read_batch < 0:
                raise ValueError(
                    f"read_batch must be >= 0, got {self.read_batch}")
            if self.read_path not in ("readindex", "lease"):
                raise ValueError(
                    f"read_path must be readindex or lease, got "
                    f"{self.read_path!r}")
        if self.series_windows < 0 or self.event_capacity < 0:
            raise ValueError(
                f"series_windows/event_capacity must be >= 0, got "
                f"{self.series_windows}/{self.event_capacity}")
        if self.series_stride < 0:
            raise ValueError(
                f"series_stride must be >= 0, got {self.series_stride}")
        if self.series_stride > 0 and self.series_windows <= 0:
            raise ValueError(
                "series_stride needs series_windows > 0 — a stride "
                "without a ring samples into nothing")
        s = self.scenario
        if s is not None and s.has_clients and self.serve_slots <= 0:
            raise ValueError(
                "client-stream channels need serve_slots > 0 — the "
                "generated commands must have an applied store to land in")
        if s is not None and not s.degenerate:
            if s.delay_windows and not self.delay_lo < self.delay_hi:
                raise ValueError(
                    "scenario.delay_windows needs a real run window "
                    f"(delay_lo < delay_hi), got {self.delay_lo}/{self.delay_hi}")
            if s.partitions and self.n_nodes < 2:
                raise ValueError("partition programs need n_nodes >= 2")
            if s.timeout_windows and not self.el_lo < self.el_hi:
                raise ValueError(
                    "scenario.timeout_windows needs a real election window "
                    f"(el_lo < el_hi), got {self.el_lo}/{self.el_hi}")

    @property
    def uses_mailbox(self) -> bool:
        """Whether exchanges route through the deliverable-at-tick mailbox
        (SEMANTICS.md §10) instead of resolving synchronously within the tick."""
        return self.mailbox or self.delay_hi > 0

    @property
    def uses_compaction(self) -> bool:
        """Whether the §15 snapshot/compaction subsystem is compiled in:
        snapshot state present, ring-window log addressing, InstallSnapshot
        exchanges, the end-of-tick fold phase. False (W = 0) compiles the
        bit-identical pre-§15 program — THE migration-equality switch."""
        return self.compact_watermark > 0

    @property
    def uses_serving(self) -> bool:
        """Whether the §20 serving path is compiled in: the applied KV
        store, the read path, the client-latency histograms, and (when the
        bank carries client channels) the device-resident load generator.
        False (S = 0) compiles the bit-identical pre-§20 program."""
        return self.serve_slots > 0

    @property
    def uses_ops_plane(self) -> bool:
        """Whether the §21 streaming ops plane rides the monitor carry:
        the multi-channel series ring and/or the bounded event ring.
        False (both 0) compiles the bit-identical pre-§21 carry."""
        return self.series_windows > 0 or self.event_capacity > 0

    @property
    def known_delivery(self) -> bool:
        """Whether every §10 delivery is fully determined at tick start:
        delay_lo >= 1 forbids same-tick send-and-deliver, so each tick's
        delivery set comes entirely from slots filled on EARLIER ticks.
        This is the regime where the batched/frontier-cache deep engines
        run under the mailbox (ops/tick.py BodyFlags.batched, r7); τ=0
        mailbox configs keep the per-pair engine."""
        return self.uses_mailbox and self.delay_lo >= 1

    @property
    def phys_capacity(self) -> int:
        """Physical rows per (node, group) log plane — the allocation and
        ring-translate modulus every engine uses (§16). ring_capacity when
        set, else log_capacity: logical positions are bounded by
        log_capacity without compaction, by nothing (i32) with it."""
        return (self.ring_capacity if self.ring_capacity is not None
                else self.log_capacity)

    @property
    def uses_dyn_log(self) -> bool:
        """Whether the kernel uses dynamic (gather/scatter) log addressing —
        the deep-log band. THE one threshold shared by engine selection
        (ops/tick.make_aux), backend choice (ops/pallas_tick.choose_impl),
        and sharded-run routing (parallel/mesh.make_sharded_run). Keyed on
        the PHYSICAL window (§16): a deep logical capacity bounded to a
        small ring addresses few enough resident rows for the shallow
        band's columnar one-hot forms — the ring's perf lever."""
        return self.phys_capacity >= 256

    @property
    def majority(self) -> int:
        # RaftServer.kt:44
        return self.n_nodes // 2 + 1

    # -- HBM budget (BASELINE config 5 planning; SURVEY.md:350-352) -----------

    def state_bytes_per_group(self) -> int:
        """Bytes of RaftState per group under this config (log dtype included).
        The log dominates for deep-log configs: N * C_phys * 2 arrays —
        physical rows, so a §16 ring window shrinks the byte model by
        ~C / C_phys."""
        N, C = self.n_nodes, self.phys_capacity
        itemsize = 2 if self.log_dtype == "int16" else 4
        log = N * C * 2 * itemsize
        per_node_i32 = 17 * N * 4     # (N,) int32 grids incl. counters/timers
        per_node_b = 3 * N * 1        # el_armed/hb_armed/up as packed bool
        pair = 3 * N * N * 4 + N * N  # responded/next/match (+link_up bool)
        mail = 13 * N * N * 4 if self.uses_mailbox else 0
        return log + per_node_i32 + per_node_b + pair + mail

    def hbm_bytes(self, working_factor: float = 2.0) -> int:
        """Estimated device-memory footprint of a run: state x working_factor
        (XLA holds input + output copies of the state across a tick; donation
        reduces but rarely eliminates the second copy) plus per-tick aux masks."""
        aux = self.n_groups * (self.n_nodes ** 2) * 5  # masks, generously
        return int(self.n_groups * self.state_bytes_per_group() * working_factor + aux)

    def max_groups_for_hbm(self, hbm_bytes: int = 14 * 10**9,
                           working_factor: float = 2.0) -> int:
        """Largest n_groups fitting `hbm_bytes` (default: one 16 GB chip with 2 GB
        headroom) under this config's per-group cost — the groups-per-chip
        ceiling for BASELINE config-5 planning."""
        per = self.state_bytes_per_group() * working_factor + self.n_nodes ** 2 * 5
        return int(hbm_bytes // per)

    def stressed(self, factor: int = 10) -> "RaftConfig":
        """A time-compressed variant: all pacing constants divided by `factor`.

        Preserves the reference's ratios (timeout : heartbeat : backoff) while packing
        `factor`x more protocol activity into each wall-clock second of simulation —
        used by election-churn benchmarks.
        """
        return dataclasses.replace(
            self,
            el_lo=max(1, self.el_lo // factor),
            el_hi=max(1, self.el_hi // factor),
            hb_ticks=max(1, self.hb_ticks // factor),
            round_ticks=max(1, self.round_ticks // factor),
            retry_ticks=max(1, self.retry_ticks // factor),
            bo_lo=max(1, self.bo_lo // factor),
            bo_hi=max(1, self.bo_hi // factor),
        )
