"""The per-layer metrics' arithmetic on synthetic scrapes and profile
summaries, the profile reduction, and the judgement of a run's answers."""

import hashlib

import pytest

from portbench import check, profile, spec
from portbench.run import Sent, _breakdown
from portbench.window import Window, exact_percentile

from conftest import REPO

PEAK = {"int_ops_per_clock_per_sm": 128, "sms": 132, "clock_mhz": 1980}
CONFIG = {"Workers": 2, "hash_model": "md5", "ops_per_hash": 215}


def _snap(counters=None, **hists):
    return {"counters": counters or {},
            "histograms": {k.replace("__", "."): {"count": c, "sum": s}
                           for k, (c, s) in hists.items()}}


def _readers():
    cell = spec.load(REPO, "md5-1w.d8-closed4")
    return cell.readers


def _window(**kw):
    base = dict(seconds=10.0, config=CONFIG, solves=[(8, 0.2, 16 ** 8)] * 4,
                coordinator=(_snap(), _snap()), workers=[(_snap(), _snap())] * 2)
    base.update(kw)
    return Window(**base)


def test_coordinator_means_are_window_differences():
    r = _readers()
    coord = (_snap(coord__first_result_s=(10, 1.0), coord__cancel_propagation_s=(10, 1.5)),
             _snap(coord__first_result_s=(14, 1.8), coord__cancel_propagation_s=(14, 2.34)))
    w = _window(coordinator=coord)
    assert r["coord.first_result_ms"](w) == pytest.approx(200.0)
    # 0.84 s over 4 rounds less 0.8 s over 4
    assert r["coord.cancel_ms"](w) == pytest.approx(10.0)
    assert r["coord.first_result_ms"](_window()) is None
    assert r["coord.cancel_ms"](_window()) is None
    # a round with its first result but not its last ACK at the close
    coord = (coord[0], _snap(coord__first_result_s=(15, 2.0),
                             coord__cancel_propagation_s=(14, 2.34)))
    assert r["coord.cancel_ms"](_window(coordinator=coord)) == pytest.approx(10.0)


def test_worker_and_driver_read_every_worker():
    r = _readers()
    workers = [(_snap(worker__solve_s=(1, 0.1), search__poll_s=(5, 0.5)),
                _snap(worker__solve_s=(3, 0.5), search__poll_s=(9, 0.9), search__launch_s=(2, 0.1))),
               (_snap(), _snap(worker__solve_s=(2, 0.4), search__poll_s=(1, 0.3)))]
    w = _window(workers=workers)
    assert r["worker.solve_ms"](w) == pytest.approx(200.0)  # 0.8 s over 4 solves
    assert r["search.launch_ms_per_solve"](w) == pytest.approx(200.0)  # 0.8 s over 4
    assert r["search.launch_ms_per_solve"](_window(workers=workers, solves=[])) is None


def test_kernel_roofline_and_device_idle_read_the_profiles():
    r = _readers()
    ops_per_s = 128 * 132 * 1980e6
    # four solves of 16**8 candidates each on both workers, at 60 % of the peak
    kernel_s = 2 * 4 * 16 ** 8 * 215 / ops_per_s / 0.6
    profiles = [{"window_s": 10.0, "busy_s": 9.0,
                 "device_ops": {"void distpow::hash_persistent_kernel<Md5<1>>": kernel_s / 2,
                                "Memcpy DtoH": 1.0}},
                {"window_s": 10.0, "busy_s": 8.0,
                 "device_ops": {"void distpow::resident_hash_search_kernel<Md5<1>>": kernel_s / 2}}]
    w = _window(profiles=profiles, peak=PEAK)
    assert r["kernel_roofline"](w) == pytest.approx(60.0)
    # the work is the candidates tried, not the difficulty's expectation
    w = _window(profiles=profiles, peak=PEAK, solves=[(8, 0.2, 16 ** 8 // 2)] * 4)
    assert r["kernel_roofline"](w) == pytest.approx(30.0)
    assert r["device_idle"](w) == pytest.approx(15.0)
    assert r["kernel_roofline"](_window(profiles=profiles)) is None  # an unknown card
    assert r["kernel_roofline"](_window(peak=PEAK)) is None  # not traced
    idle = [{"window_s": 10.0, "busy_s": 0.0, "device_ops": {}}]
    assert r["device_idle"](_window(profiles=idle)) is None
    assert r["kernel_roofline"](_window(profiles=idle, peak=PEAK)) is None


def test_profile_summary_unions_device_time_and_names_gaps():
    ms = 1_000_000
    # the first kernel began before the trace and the last ends after it
    device = [("k1", -5 * ms, 15 * ms), ("k1", 5 * ms, 10 * ms), ("copy", 20 * ms, 1 * ms),
              ("k2", 40 * ms, 15 * ms)]
    host = [("poll", 0, 2 * ms), ("cudaEventQuery", 16 * ms, 2 * ms),
            ("aten::empty", 22 * ms, 10 * ms), ("cudaLaunchKernel", 30 * ms, 1 * ms),
            ("poll", 48 * ms, 2 * ms)]
    s = profile.summarize(device, host, 0.04)
    assert s["window_s"] == pytest.approx(0.050)  # the first to the last host operation
    assert s["busy_s"] == pytest.approx(0.026)  # 0-15, 20-21 and 40-50 ms
    assert s["device_ops"]["k1"] == pytest.approx(0.020)
    assert s["device_ops"]["k2"] == pytest.approx(0.010)
    assert s["idle_gaps"][0] == ["aten::empty", pytest.approx(0.019)]
    assert s["idle_gaps"][1] == ["cudaEventQuery", pytest.approx(0.005)]
    assert len(s["idle_gaps"]) == 2
    busy = [("k", 0, 60 * ms)]  # a card busy all through never reads more than its window
    full = profile.summarize(busy, host, 0.04)
    assert full["busy_s"] == full["window_s"]
    assert profile.summarize([], host, 0.04) == {
        "window_s": pytest.approx(0.050), "busy_s": 0.0, "device_ops": {},
        "idle_gaps": [["aten::empty", pytest.approx(0.050)]]}
    assert profile.summarize(device, [], 0.04) == {"window_s": 0.04, "busy_s": 0.0,
                                                   "device_ops": {}, "idle_gaps": []}
    b = _breakdown([s, s])
    assert b["device_ops"][0] == ["k1", pytest.approx(0.040)]
    assert len(b["idle_gaps"]) == 4 and b["idle_gaps"][0][1] == pytest.approx(0.019)


def test_exact_percentile_is_nearest_rank():
    xs = [float(i) for i in range(1, 101)]
    assert exact_percentile(xs, 0.5) == 51.0 and exact_percentile(xs, 0.95) == 95.0
    assert exact_percentile([], 0.5) is None


def _secret(nonce, ntz, first=0):
    for i in range(1 << 20):
        s = bytes([first]) + i.to_bytes(3, "little")
        if hashlib.md5(nonce + s).hexdigest().endswith("0" * ntz):
            return s
    raise AssertionError


def test_judge_counts_every_kind_of_fault():
    n = b"\x01\x02\x03\x04"
    good = _secret(n, 2, first=0x80)
    window = [Sent(n, 2, 0.0, True, 0.1, good),
              Sent(n, 2, 0.0, True, 0.1, good[:-1] + bytes([good[-1] ^ 1])),
              Sent(n, 2, 0.0, True, 0.1, None, "degraded"),
              Sent(n, 2, 0.0, True)]
    coord = {"counters": {"coord.fanouts": 10}}
    workers = [{"counters": {"worker.mine_rpcs": 10, "worker.found_rpcs": 10,
                             "worker.results_sent": 20}},
               {"counters": {"worker.mine_rpcs": 9, "worker.found_rpcs": 8,
                             "worker.results_sent": 18}}]
    c = check.judge(CONFIG, window, coord, workers, [(good, 1), (good, 0)])
    got = {k: v["value"] for k, v in c.items()}
    assert got == {"unanswered": 1, "errors": 1, "bad_secrets": 1, "fanout_short": 1,
                   "found_short": 1, "ack_short": 1, "partition_misses": 1}
    assert all(v["limit"] == 0 for v in c.values())
    clean = check.judge(CONFIG, window[:1], coord, workers[:1] * 2, [(good, 1)])
    assert all(v["value"] == 0 for v in clean.values())
