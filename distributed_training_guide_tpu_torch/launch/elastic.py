"""World-size renegotiation for the elastic supervisor.

Counterpart of ``distributed_training_guide_tpu/launch/elastic.py``. The
restart loop (``launch/supervisor.py``) has torchrun's elasticity: restart
everything and resume on the SAME world. A fleet loses slices and gains
capacity while running; this module turns a slice loss into "shrink and
continue": membership comes from per-slice heartbeat files, a new world is
agreed through a barrier'd proposal file, and each surviving supervisor
re-execs its worker on the agreed world (the checkpoint reshards onto it
on restore: ``checkpoint/reshard.py``).

The protocol, all files under one shared ``--elastic-dir``, byte for byte
the JAX package's (a JAX member and a port member agree on one directory):

- **Membership** (``members/<name>.json``): every slice's supervisor beats
  its member file (atomic tmp + rename); liveness is the payload
  timestamp's age. A slice silent for ``liveness_timeout`` seconds is
  LOST; a fresh file is a slice JOINING.
- **World agreement** (``world.proposal.json`` -> ``world.json``): the
  LEADER, the smallest live member name, proposes ``{world_id, members,
  trigger}``; every other proposed member acks with
  ``world.ack.<name>.json`` carrying the proposal's world_id (the id is
  the fence: a stale ack names an old id). When all acked, the leader
  publishes ``world.json`` (the barrier). A member that does not ack in
  time is dropped and the leader proposes again without it. A member
  outside a published world is FENCED OUT and exits.
- **Events** (``elastic.jsonl``): one line per renegotiation: old world,
  new world, trigger, wall time.

Where the port differs: a torch rank is one device, so the agreed world
reaches the worker through its command (``{world_devices}``, e.g.
``launch.local --nproc {world_devices}``, and ``{world_batch}``) and the
``DTG_WORLD_*`` variables; no host-platform device count is forced.
``python -m distributed_training_guide_tpu_torch.launch.elastic --member
<name> --dir <d>`` is a peer slice without a worker (beat and ack), whose
loss ``DTG_FAULT_SLICE_LOSS=<name>@<beat>`` injects.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Optional

from ..utils import faults

MEMBERS_DIR = "members"
WORLD_FILE = "world.json"
PROPOSAL_FILE = "world.proposal.json"
EVENTS_FILE = "elastic.jsonl"


class FencedOutError(RuntimeError):
    """This member is not part of the agreed world: the fleet moved on
    without it (it was presumed dead, or explicitly removed). The only
    correct response is to exit — rejoining happens by beating again and
    letting the leader renegotiate a larger world."""


def _write_json_atomic(path: Path, payload: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "w") as fp:
        json.dump(payload, fp)
    os.replace(tmp, path)  # readers never see torn JSON


def _read_json(path: Path) -> Optional[dict]:
    try:
        with open(path) as fp:
            payload = json.load(fp)
    except (OSError, json.JSONDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


def append_event(coord_dir: Path, event: dict) -> None:
    """One line to ``elastic.jsonl`` (wall-clock stamped): the membership
    timeline post-mortems reconstruct. Append-only, flushed per line."""
    path = Path(coord_dir) / EVENTS_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fp:
        fp.write(json.dumps({"wall_time": time.time(), **event}) + "\n")


def read_events(coord_dir: Path) -> list[dict]:
    out = []
    try:
        with open(Path(coord_dir) / EVENTS_FILE) as fp:
            for line in fp:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


class SliceMember:
    """One slice's presence in the coordination directory."""

    def __init__(self, coord_dir: Path, name: str):
        if "/" in name or not name:
            raise ValueError(f"member name must be a plain token, got "
                             f"{name!r}")
        self.coord_dir = Path(coord_dir)
        self.name = name
        self.path = self.coord_dir / MEMBERS_DIR / f"{name}.json"
        self.beats = 0

    def beat(self) -> None:
        self.beats += 1
        _write_json_atomic(self.path, {"name": self.name,
                                       "time": time.time(),
                                       "beats": self.beats,
                                       "pid": os.getpid()})

    def retire(self) -> None:
        """Clean departure (drain, not death): the file goes away, so the
        next liveness scan shrinks the world without waiting out the
        timeout."""
        try:
            self.path.unlink()
        except OSError:
            pass


def live_members(coord_dir: Path, liveness_timeout_s: float,
                 now: Optional[float] = None) -> list[str]:
    """Names whose member file's payload timestamp is fresh, sorted (the
    sort defines leadership: index 0 proposes)."""
    now = time.time() if now is None else now
    out = []
    mdir = Path(coord_dir) / MEMBERS_DIR
    try:
        entries = sorted(mdir.glob("*.json"))
    except OSError:
        return []
    for path in entries:
        payload = _read_json(path)
        if payload is None or "time" not in payload:
            continue
        if now - float(payload["time"]) <= liveness_timeout_s:
            out.append(payload.get("name", path.stem))
    return sorted(set(out))


class WorldNegotiator:
    """The agreement protocol for one member (leader or follower decided
    per-negotiation by who sorts first among the live)."""

    def __init__(self, coord_dir: Path, name: str, *,
                 ack_timeout_s: float = 10.0, poll_s: float = 0.05,
                 on_poll=None):
        self.coord_dir = Path(coord_dir)
        self.name = name
        self.ack_timeout_s = ack_timeout_s
        self.poll_s = poll_s
        # called on every wait-loop tick (the supervisor wires its own
        # membership beat here: an agreement round can outlast the
        # liveness timeout, and a negotiator that stops beating while it
        # waits would read as a lost slice to everyone else)
        self.on_poll = on_poll

    # ---- shared views ------------------------------------------------------
    def current(self) -> Optional[dict]:
        return _read_json(self.coord_dir / WORLD_FILE)

    def proposal(self) -> Optional[dict]:
        return _read_json(self.coord_dir / PROPOSAL_FILE)

    def _ack_path(self, member: str) -> Path:
        return self.coord_dir / f"world.ack.{member}.json"

    # ---- leader ------------------------------------------------------------
    def propose_and_agree(self, members: list[str], trigger: str) -> dict:
        """Barrier'd agreement: propose ``members`` (self always
        included), collect id-fenced acks from every OTHER member, publish
        ``world.json``. Ack stragglers are dropped and the next round
        proposes without them — the renegotiation a dead slice triggered
        can never be wedged by that same dead slice. Returns the published
        world; appends the renegotiation event."""
        members = sorted(set(members) | {self.name})
        old = self.current()
        world_id = int(old["world_id"]) + 1 if old else 1
        while True:
            proposal = {"world_id": world_id, "members": members,
                        "trigger": trigger, "proposed_by": self.name,
                        "proposed_at": time.time()}
            _write_json_atomic(self.coord_dir / PROPOSAL_FILE, proposal)
            waiting = [m for m in members if m != self.name]
            deadline = time.time() + self.ack_timeout_s
            while waiting and time.time() < deadline:
                if self.on_poll is not None:
                    self.on_poll()
                for m in list(waiting):
                    ack = _read_json(self._ack_path(m))
                    # the world_id in the ack payload is the fence: an ack
                    # file left by an earlier incarnation names an old id
                    if ack and int(ack.get("world_id", -1)) == world_id:
                        waiting.remove(m)
                if waiting:
                    time.sleep(self.poll_s)
            if not waiting:
                break
            # stragglers are presumed dead: drop them and re-propose (a
            # fresh world_id so their late acks to THIS round can't count)
            members = [m for m in members if m not in waiting]
            world_id += 1
            if members == [self.name]:
                # no one left to wait for — the next loop publishes
                # immediately (the single-member world)
                continue
        world = {"world_id": world_id, "members": members,
                 "trigger": trigger, "agreed_at": time.time()}
        _write_json_atomic(self.coord_dir / WORLD_FILE, world)
        for m in members:
            try:                      # consumed acks: best-effort cleanup
                self._ack_path(m).unlink()
            except OSError:
                pass
        try:
            (self.coord_dir / PROPOSAL_FILE).unlink()
        except OSError:
            pass
        append_event(self.coord_dir, {
            "event": "renegotiated", "trigger": trigger,
            "old_world": ({"world_id": old["world_id"],
                           "members": old["members"]} if old else None),
            "new_world": {"world_id": world_id, "members": members},
        })
        return world

    # ---- follower ----------------------------------------------------------
    def maybe_ack(self) -> Optional[int]:
        """Ack the live proposal if one names a newer world than the
        published one. Returns the acked world_id (or None). A proposal
        that EXCLUDES this member is not acked — ``follow`` raises
        FencedOutError when the exclusion publishes."""
        proposal = self.proposal()
        if proposal is None:
            return None
        current = self.current()
        if current and int(proposal["world_id"]) <= int(current["world_id"]):
            return None
        if self.name not in proposal.get("members", []):
            return None
        wid = int(proposal["world_id"])
        _write_json_atomic(self._ack_path(self.name),
                           {"world_id": wid, "member": self.name,
                            "acked_at": time.time()})
        return wid

    def follow(self, min_world_id: int, timeout_s: float, *,
               joining: bool = False) -> dict:
        """Follower barrier: ack proposals as they appear and wait for a
        published world newer than ``min_world_id``. A published world
        that EXCLUDES this member raises FencedOutError — unless
        ``joining``: a member that was never part of a world cannot be
        fenced by one that predates its join (a stale ``world.json`` on
        a reused coordination dir, or a scale-UP joiner arriving
        mid-run); it keeps beating and waits for the leader's membership
        poll to propose a world that admits it."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.on_poll is not None:
                self.on_poll()
            self.maybe_ack()
            world = self.current()
            if world and int(world["world_id"]) > min_world_id:
                if self.name in world.get("members", []):
                    return world
                if not joining:
                    raise FencedOutError(
                        f"member {self.name!r} is not part of world "
                        f"{world['world_id']} ({world['members']}); the "
                        f"fleet renegotiated without it")
            time.sleep(self.poll_s)
        raise TimeoutError(
            f"no world {'admitting ' + repr(self.name) if joining else ''}"
            f"newer than {min_world_id} published within "
            f"{timeout_s}s (leader dead and no one took over?)")


# ---- supervisor-side runtime -----------------------------------------------

@dataclasses.dataclass
class ElasticConfig:
    """The supervisor's ``--elastic-*`` knobs in one place."""
    coord_dir: Path
    member: str = "slice0"
    devices_per_slice: int = 1
    liveness_timeout_s: float = 5.0
    ack_timeout_s: float = 15.0
    settle_s: float = 1.0            # startup window for peers to appear
    global_batch: Optional[int] = None  # backs the {world_batch} token


class ElasticRuntime:
    """What the supervisor drives: beat membership, agree on worlds, and
    answer "did the world change under my running worker?"."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self.member = SliceMember(cfg.coord_dir, cfg.member)
        # the negotiator beats our member file on every wait tick: an
        # agreement round or a long follow can outlast the liveness
        # timeout, and going silent mid-negotiation would read as a lost
        # slice to every peer
        self.negotiator = WorldNegotiator(cfg.coord_dir, cfg.member,
                                          ack_timeout_s=cfg.ack_timeout_s,
                                          on_poll=self.member.beat)
        self.world: Optional[dict] = None

    # ---- views -------------------------------------------------------------
    def live(self) -> list[str]:
        return live_members(self.cfg.coord_dir, self.cfg.liveness_timeout_s)

    def is_leader(self, live: Optional[list[str]] = None) -> bool:
        """Process 0 of the agreement: the smallest live member name —
        computed per negotiation, so leadership survives leader loss."""
        live = self.live() if live is None else live
        return bool(live) and live[0] == self.cfg.member

    def world_devices(self) -> int:
        n = len(self.world["members"]) if self.world else 1
        return max(1, n) * self.cfg.devices_per_slice

    # ---- negotiation -------------------------------------------------------
    def establish(self, trigger: str) -> dict:
        """Negotiate into the next world (leader) or follow the leader's
        proposal (follower). Called at startup and after every membership
        change; raises FencedOutError when the agreed world excludes this
        member."""
        self.member.beat()
        if trigger == "start":
            # give peers one settle window to beat before the first world
            # is cut — without it the first supervisor up always agrees a
            # 1-member world and immediately renegotiates
            deadline = time.time() + self.cfg.settle_s
            seen = self.live()
            while time.time() < deadline:
                time.sleep(0.1)
                now_live = self.live()
                if now_live != seen:
                    seen, deadline = now_live, time.time() + self.cfg.settle_s
        prev_id = int(self.world["world_id"]) if self.world else 0
        # a member that has never been part of a world is JOINING: a
        # published world that excludes it (a stale world.json on a
        # reused dir, or a scale-up join mid-run) must not fence it —
        # it waits for the leader's membership poll to admit it, which
        # can take the leader a worker-SIGTERM's worth of time
        joining = self.world is None
        # overall grace >> one follow window: the leader may spend a full
        # worker-SIGTERM grace (30s) before it even proposes, and it may
        # itself die mid-negotiation — each short follow timeout
        # re-checks leadership, so a follower whose leader vanished takes
        # over instead of crashing on TimeoutError
        deadline = time.time() + max(
            120.0, 3 * (self.cfg.ack_timeout_s
                        + self.cfg.liveness_timeout_s))
        while True:
            live = self.live()
            if self.cfg.member not in live:  # our own beat should be fresh
                live = sorted(set(live) | {self.cfg.member})
            if self.is_leader(live):
                self.world = self.negotiator.propose_and_agree(live,
                                                               trigger)
                return self.world
            try:
                self.world = self.negotiator.follow(
                    prev_id, joining=joining,
                    timeout_s=min(self.cfg.ack_timeout_s
                                  + self.cfg.liveness_timeout_s,
                                  max(1.0, deadline - time.time())))
                return self.world
            except TimeoutError:
                if time.time() >= deadline:
                    raise

    def poll(self) -> Optional[str]:
        """One monitoring tick while the worker runs: beat membership, ack
        any live proposal (so the leader's barrier never waits on us), and
        return a renegotiation trigger when the world changed — a slice
        lost/joined (liveness vs the agreed membership) or another
        leader's newer proposal/world on disk."""
        self.member.beat()
        self.negotiator.maybe_ack()
        if self.world is None:
            return "start"
        current = self.negotiator.current()
        if current and int(current["world_id"]) > int(self.world["world_id"]):
            return "world_moved"       # agreed while we weren't looking
        proposal = self.negotiator.proposal()
        if proposal and int(proposal.get("world_id", 0)) \
                > int(self.world["world_id"]):
            return "proposal"
        live = set(self.live()) | {self.cfg.member}
        agreed = set(self.world["members"])
        if live - agreed:
            return "slice_joined"
        if agreed - live:
            return "slice_lost"
        return None

    def retire(self) -> None:
        self.member.retire()


def render_worker_cmd(cmd: list[str], world_devices: int,
                      global_batch: Optional[int] = None) -> list[str]:
    """Substitute the agreed world into the worker command:
    ``{world_devices}`` -> the world's total device count (a gang's
    ``--nproc``), and
    ``{world_batch}`` -> ``global_batch // world_devices`` (requires
    ``--elastic-global-batch``) — the per-data-shard batch that keeps the
    GLOBAL batch invariant across world sizes, which is what makes a
    shrink-and-continue trajectory comparable to the uninterrupted run
    (``related-topics/elastic-training`` "Dynamic world size")."""
    out = []
    for arg in cmd:
        if "{world_batch}" in arg:
            if global_batch is None:
                raise ValueError(
                    "worker command uses {world_batch} but no "
                    "--elastic-global-batch was given")
            if global_batch % world_devices:
                raise ValueError(
                    f"--elastic-global-batch {global_batch} is not "
                    f"divisible by the world's {world_devices} devices")
            arg = arg.replace("{world_batch}",
                              str(global_batch // world_devices))
        out.append(arg.replace("{world_devices}", str(world_devices)))
    return out


def worker_world_env(env: dict, world: dict, world_devices: int) -> dict:
    """Mutate a worker env with the agreed world's ``DTG_WORLD_*`` facts
    (its id, members and device count). Nothing else: the device count
    reaches a torch worker through ``{world_devices}`` in its command (one
    rank a device), never through an XLA flag."""
    env["DTG_WORLD_ID"] = str(world["world_id"])
    env["DTG_WORLD_MEMBERS"] = ",".join(world["members"])
    env["DTG_WORLD_DEVICES"] = str(world_devices)
    return env


# ---- the member helper (a peer slice without a local worker) ---------------

def run_member(coord_dir: Path, name: str, *, interval_s: float = 0.2,
               max_beats: Optional[int] = None) -> int:
    """Beat + ack until fenced out (or the fault kills us): the process
    shape of a peer slice's supervisor as seen by the coordination dir.
    Used by the chaos drills (and usable by operators rehearsing one):
    ``DTG_FAULT_SLICE_LOSS=<name>@<beat>`` makes this member die WITHOUT
    retiring its file — the no-cleanup slice loss the liveness timeout
    exists for."""
    member = SliceMember(coord_dir, name)
    negotiator = WorldNegotiator(coord_dir, name)
    was_member = False
    while max_beats is None or member.beats < max_beats:
        if faults.slice_fault(name, member.beats):
            print(f"[elastic-member {name}] injected slice loss at beat "
                  f"{member.beats}", flush=True)
            return 1                  # no retire(): the file goes stale
        member.beat()
        negotiator.maybe_ack()
        world = negotiator.current()
        in_world = bool(world and name in world.get("members", []))
        was_member = was_member or in_world
        if was_member and world and not in_world:
            # exclusion fences only a member the fleet once HELD: a world
            # that predates this member's join (stale world.json on a
            # reused dir, or a scale-up join) must not fence the joiner —
            # it keeps beating until the leader's membership poll admits
            # it
            print(f"[elastic-member {name}] fenced out of world "
                  f"{world['world_id']}; exiting", flush=True)
            member.retire()
            return 0
        time.sleep(interval_s)
    member.retire()
    return 0


def main():
    parser = argparse.ArgumentParser(
        description="elastic coordination member helper (beat + ack)")
    parser.add_argument("--member", required=True,
                        help="this slice's member name")
    parser.add_argument("--dir", required=True,
                        help="the shared --elastic-dir coordination dir")
    parser.add_argument("--interval", type=float, default=0.2)
    parser.add_argument("--max-beats", type=int, default=None)
    args = parser.parse_args()
    raise SystemExit(run_member(Path(args.dir), args.member,
                                interval_s=args.interval,
                                max_beats=args.max_beats))


if __name__ == "__main__":
    main()
