"""Cluster-wide GPU monitor with activity and hang detection.

Counterpart of ``distributed_training_guide_tpu/monitor/top_cluster.py``
and of the reference's ``top-cluster.py`` (ssh + ``nvidia-smi`` on every
host), with the reference's hang rule (``diagnosing-errors/README.md``): a
node is wedged when its power draw drops while a job's memory stays
resident. TPUs expose no power reading, so the JAX package watches
allocator churn and calls a host static when two polls read the same
signature; a power reading never repeats exactly, so here a poll is QUIET
when every GPU of the host draws under ``IDLE_POWER_FRAC`` of its power
limit (or, with no power reading, runs at 0% utilization). JAX's state
machine is kept: a host's ``static_polls`` counts its quiet polls in a row
after its first poll, and ``alert_after`` of them (default 3) read
``stalled`` when memory is resident (``idle`` when not); any active poll
reads ``ok`` and resets the count; a failed poll reads ``error``.

``local_stats`` runs ``nvidia-smi`` and imports no torch, so ``--local``
stays quick; it is also the payload ``poll_host`` runs over ssh.

    python -m distributed_training_guide_tpu_torch.monitor.top_cluster --local
    python -m distributed_training_guide_tpu_torch.monitor.top_cluster \\
        --hosts hosts.txt --interval 10 --alert-after 3
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

SMI_FIELDS = ("index", "name", "memory.used", "memory.total", "power.draw",
              "power.limit", "utilization.gpu")
RESIDENT_GB = 0.05      # a job's tensors are on the cards (as in JAX)
# an H100 (700 W) idles at ~130 W with a context resident and trains a 1B
# model at ~630 W (PERF.md, phase 26 (d)): a quarter of the limit parts them
IDLE_POWER_FRAC = 0.25


def _number(text: str) -> Optional[float]:
    """A CSV field of ``nvidia-smi ... nounits`` as a float; None for the
    "[N/A]" / "[Not Supported]" a card without the sensor prints."""
    try:
        return float(text)
    except ValueError:
        return None


def parse_smi_csv(text: str) -> list:
    """One device dict per line of ``nvidia-smi --query-gpu=<SMI_FIELDS>
    --format=csv,noheader,nounits``: memory in GB (1e9 bytes), power in
    W, utilization in percent."""
    devs = []
    for line in text.strip().splitlines():
        cells = [c.strip() for c in line.split(",")]
        if len(cells) != len(SMI_FIELDS):
            continue
        idx, name, used, total, draw, limit, util = cells
        devs.append({
            "id": int(idx), "kind": name,
            "hbm_gb": round((_number(used) or 0.0) * 2 ** 20 / 1e9, 3),
            "hbm_limit_gb": round((_number(total) or 0.0) * 2 ** 20 / 1e9, 3),
            "power_w": _number(draw), "power_limit_w": _number(limit),
            "util_pct": _number(util)})
    return devs


def local_stats() -> dict:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True)
    return {"host": os.uname().nodename, "devices": parse_smi_csv(out.stdout)}


def poll_host(host: str, timeout: float = 20.0) -> dict:
    cmd = ["ssh", "-o", "ConnectTimeout=5", host,
           "python -m distributed_training_guide_tpu_torch.monitor."
           "top_cluster --local"]
    try:
        out = subprocess.run(cmd, capture_output=True, timeout=timeout,
                             text=True)
        return json.loads(out.stdout.strip().splitlines()[-1])
    except Exception as e:  # noqa: BLE001 - any failure is the row's error
        return {"host": host, "error": str(e)}


def device_quiet(dev: dict) -> bool:
    """No work on this GPU: power under ``IDLE_POWER_FRAC`` of its limit,
    or, without a power reading, 0% utilization."""
    draw, limit = dev.get("power_w"), dev.get("power_limit_w")
    if draw is not None and limit:
        return draw < IDLE_POWER_FRAC * limit
    return not dev.get("util_pct")


class ClusterWatch:
    """Per-host activity tracking and stall detection (pure logic: the ssh
    loop feeds it, the tests feed it canned polls)."""

    def __init__(self, alert_after: int = 3):
        self.alert_after = alert_after
        self._seen: set = set()
        self._static_polls: dict = {}

    def update(self, stats: dict) -> dict:
        """Digest one host's poll -> row dict with keys host, status (ok |
        idle | stalled | error), hbm_gb, hbm_limit_gb, n_devices,
        static_polls, power_w, power_limit_w."""
        host = stats.get("host", "?")
        if "error" in stats:
            return {"host": host, "status": "error", "error": stats["error"]}
        devs = stats["devices"]
        used = sum(d["hbm_gb"] for d in devs)
        limit = sum(d["hbm_limit_gb"] for d in devs)
        quiet = all(device_quiet(d) for d in devs)
        # a host's first poll has nothing to stay quiet since (JAX: no
        # earlier signature to repeat)
        if quiet and host in self._seen:
            self._static_polls[host] = self._static_polls.get(host, 0) + 1
        else:
            self._static_polls[host] = 0
        self._seen.add(host)

        static = self._static_polls[host]
        resident = used > RESIDENT_GB
        if resident and static >= self.alert_after:
            status = "stalled"
        elif static >= self.alert_after:
            status = "idle"
        else:
            status = "ok"
        return {"host": host, "status": status, "hbm_gb": used,
                "hbm_limit_gb": limit, "n_devices": len(devs),
                "static_polls": static,
                "power_w": sum(d.get("power_w") or 0.0 for d in devs),
                "power_limit_w": sum(d.get("power_limit_w") or 0.0
                                     for d in devs)}


def format_row(row: dict) -> str:
    if row["status"] == "error":
        return f"{row['host']:<24} ERROR {row['error']}"
    line = (f"{row['host']:<24} {row['n_devices']} gpus  "
            f"hbm {row['hbm_gb']:7.1f}/{row['hbm_limit_gb']:7.1f} GB  "
            f"power {row['power_w']:6.0f}/{row['power_limit_w']:6.0f} W")
    if row["status"] == "stalled":
        line += (f"  *** STALLED? power idle with memory resident for "
                 f"{row['static_polls']} polls (see diagnosing-errors/) ***")
    elif row["status"] == "idle":
        line += "  (idle)"
    return line


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--local", action="store_true")
    parser.add_argument("--hosts", default=None,
                        help="file with one host per line")
    parser.add_argument("--interval", type=float, default=10.0)
    parser.add_argument("--alert-after", type=int, default=3,
                        help="quiet polls (power idle) before a host with "
                             "resident memory is flagged STALLED")
    args = parser.parse_args()

    if args.local or not args.hosts:
        print(json.dumps(local_stats()))
        return

    hosts = [h.strip() for h in open(args.hosts) if h.strip()]
    watch = ClusterWatch(alert_after=args.alert_after)
    while True:
        t0 = time.time()
        total_used = total_limit = n_dev = n_err = n_stalled = 0
        for host in hosts:
            row = watch.update(poll_host(host))
            print(format_row(row))
            if row["status"] == "error":
                n_err += 1
                continue
            total_used += row["hbm_gb"]
            total_limit += row["hbm_limit_gb"]
            n_dev += row["n_devices"]
            n_stalled += row["status"] == "stalled"
        print(f"{'CLUSTER':<24} {n_dev} gpus  hbm {total_used:7.1f}/"
              f"{total_limit:7.1f} GB  stalled={n_stalled} "
              f"unreachable={n_err}\n")
        time.sleep(max(0.0, args.interval - (time.time() - t0)))


if __name__ == "__main__":
    main()
