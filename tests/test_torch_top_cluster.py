"""The port's cluster monitor (``monitor/top_cluster.py``) against the JAX
package's: ``nvidia-smi``'s CSV parsed from canned text (no card here),
both ``ClusterWatch`` state machines fed polls that describe the same
activity (the JAX one allocator signatures, the port's power readings)
giving the same statuses, and ``format_row``."""
import pytest

from distributed_training_guide_tpu.monitor import top_cluster as jtop
from distributed_training_guide_tpu_torch.monitor import top_cluster as ttop

SMI = """\
0, NVIDIA H100 80GB HBM3, 41234, 81559, 512.37, 700.00, 98
1, NVIDIA H100 80GB HBM3, 0, 81559, [N/A], [N/A], 0
garbage line
"""


def test_parse_smi_csv():
    devs = ttop.parse_smi_csv(SMI)
    assert len(devs) == 2
    assert devs[0] == {
        "id": 0, "kind": "NVIDIA H100 80GB HBM3",
        "hbm_gb": round(41234 * 2 ** 20 / 1e9, 3),
        "hbm_limit_gb": round(81559 * 2 ** 20 / 1e9, 3),
        "power_w": 512.37, "power_limit_w": 700.0, "util_pct": 98.0}
    assert (devs[1]["power_w"], devs[1]["power_limit_w"],
            devs[1]["hbm_gb"]) == (None, None, 0.0)


def _jax_poll(host, allocs, active, resident, error):
    """JAX's poll: ``allocs`` counts the allocations so far (it moved since
    the previous poll when active)."""
    if error:
        return {"host": host, "error": "ssh: timed out"}
    return {"host": host, "devices": [{
        "id": 0, "kind": "TPU v5 lite", "num_allocs": allocs,
        "hbm_gb": 12.0 if resident else 0.0, "hbm_peak_gb": 12.0,
        "hbm_limit_gb": 16.0}]}


def _torch_poll(host, n, active, resident, error):
    """The port's poll: power above the idle fraction when active."""
    if error:
        return {"host": host, "error": "ssh: timed out"}
    return {"host": host, "devices": [{
        "id": 0, "kind": "NVIDIA H100 80GB HBM3",
        "hbm_gb": 12.0 if resident else 0.0, "hbm_limit_gb": 85.5,
        "power_w": 400.0 + n if active else 90.0 + 0.1 * n,
        "power_limit_w": 700.0, "util_pct": 97.0 if active else 0.0}]}


# (active, resident, error) per poll; residency changes only with activity
FEEDS = {
    "training_then_hang": [(True, True, False)] * 3
    + [(False, True, False)] * 5 + [(True, True, False)] * 2,
    "hung_from_the_start": [(False, True, False)] * 6,
    "job_ends": [(True, True, False)] * 2 + [(True, False, False)]
    + [(False, False, False)] * 5,
    "errors_between": [(False, True, False), (False, False, True),
                       (False, True, False), (False, True, False),
                       (False, False, True), (False, True, False),
                       (True, True, False), (False, False, True)],
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_watches_agree_on_the_same_polls(feed):
    jw, tw = jtop.ClusterWatch(alert_after=3), ttop.ClusterWatch(
        alert_after=3)
    jrows, trows = [], []
    allocs = 0
    for n, (active, resident, error) in enumerate(FEEDS[feed], start=1):
        allocs += active and not error
        jrows.append(jw.update(_jax_poll("h0", allocs, active, resident,
                                         error)))
        trows.append(tw.update(_torch_poll("h0", n, active, resident,
                                           error)))
    assert [r["status"] for r in trows] == [r["status"] for r in jrows]
    assert [r.get("static_polls") for r in trows] == [
        r.get("static_polls") for r in jrows]
    for j, t in zip(jrows, trows):
        assert set(j) <= set(t)
    statuses = {r["status"] for r in trows}
    assert {"training_then_hang": {"ok", "stalled"},
            "hung_from_the_start": {"ok", "stalled"},
            "job_ends": {"ok", "idle"},
            "errors_between": {"ok", "stalled", "error"}}[feed] == statuses


def test_quiet_rule_and_format_row():
    w = ttop.ClusterWatch(alert_after=1)
    dev = {"id": 0, "kind": "H100", "hbm_gb": 40.0, "hbm_limit_gb": 85.5,
           "power_limit_w": 700.0, "util_pct": 0.0}
    poll = {"host": "node-7", "devices": [{**dev, "power_w": 174.0}]}
    assert w.update(poll)["status"] == "ok"          # a host's first poll
    row = w.update(poll)
    assert (row["status"], row["static_polls"]) == ("stalled", 1)
    line = ttop.format_row(row)
    assert line.startswith("node-7") and "1 gpus" in line
    assert "40.0/   85.5 GB" in line and "174/   700 W" in line
    assert "STALLED?" in line
    busy = {"host": "node-7", "devices": [{**dev, "power_w": 176.0}]}
    assert w.update(busy)["status"] == "ok"           # over 0.25 x 700
    no_power = {**dev, "power_w": None, "power_limit_w": None}
    assert ttop.device_quiet(no_power)
    assert not ttop.device_quiet({**no_power, "util_pct": 3.0})
    idle = w.update({"host": "n2", "devices": [{**dev, "hbm_gb": 0.0,
                                                "power_w": 60.0}]})
    idle = w.update({"host": "n2", "devices": [{**dev, "hbm_gb": 0.0,
                                                "power_w": 60.0}]})
    assert idle["status"] == "idle" and "(idle)" in ttop.format_row(idle)
    err = w.update({"host": "n3", "error": "unreachable"})
    assert ttop.format_row(err) == f"{'n3':<24} ERROR unreachable"
