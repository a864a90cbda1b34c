"""The benchmark's arithmetic: peaks, operation and byte counts, percentiles,
window counting and the device-timeline reduction.

Nothing here imports the port or touches a device: the CPU tests hold
every function against hand counts.  Copied, not imported, from the port
where the port already had it right: the sampler's byte bound
(``ape_x_dqn_tpu_torch/bench_sampler.py``, ``chip_smoke.phase_kernel``),
the union of device intervals and the trace summary
(``ape_x_dqn_tpu_torch/obs/trace.py``).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its full
# 700 W power limit).  The port's dueling network computes its torso
# (three convolutions and the two hidden streams) in bfloat16
# (``models/dueling.py``: compute dtype bfloat16, float32 heads), so a
# learner step's share of the chip is taken against the bfloat16 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# (kernel size, stride) of the dueling network's three convolutions.
CONV_KERNELS = ((8, 4), (4, 2), (3, 1))


def conv_out(size: int, kernel: int, stride: int) -> int:
    """Side of a VALID convolution's output."""
    return (size - kernel) // stride + 1


def dueling_layer_macs(obs_shape: Sequence[int], channels: Sequence[int], hidden: int,
                       num_actions: int) -> List[Tuple[str, int]]:
    """Multiply-accumulates of one observation through each layer of the
    conv dueling network: (layer, MACs), in forward order."""
    h, w, c = obs_shape
    out = []
    for i, (ch, (k, s)) in enumerate(zip(channels, CONV_KERNELS)):
        h, w = conv_out(h, k, s), conv_out(w, k, s)
        out.append((f"conv{i}", h * w * ch * k * k * c))
        c = ch
    flat = h * w * c
    out += [("value_hidden", flat * hidden), ("adv_hidden", flat * hidden),
            ("value", hidden), ("advantage", hidden * num_actions)]
    return out


def learner_step_flops(obs_shape: Sequence[int], channels: Sequence[int], hidden: int,
                       num_actions: int, batch: int) -> int:
    """Model FLOPs of one double-Q learner step at batch ``batch``: the
    online forward over S_t and S_{t+n} (2B rows), the target forward over
    S_{t+n} (B rows), and the backward of the B rows the loss reaches
    (weight gradients of every layer, input gradients of every layer but
    the first: the observations need none).  Two FLOPs per MAC; the
    optimizer's elementwise work is left out."""
    layers = dueling_layer_macs(obs_shape, channels, hidden, num_actions)
    fwd = sum(m for _, m in layers)
    first = layers[0][1]
    backward = 2 * fwd - first
    return 2 * (3 * batch * fwd + batch * backward)


def sampler_bytes(capacity: int, targets: int) -> int:
    """Bytes the prioritized sampler must move: every float32 mass read
    once, every float32 target read and int32 index written once."""
    return capacity * 4 + targets * 8


def sampler_bound_s(capacity: int, targets: int) -> float:
    """The sampler's least time on the card: its bytes at the HBM peak."""
    return sampler_bytes(capacity, targets) / PEAK_HBM_BYTES_PER_S


def quartiles(values: Sequence[float]) -> Tuple[float, float, float]:
    """(Q1, median, Q3) as ``statistics.quantiles(values, n=4)`` gives them
    (the exclusive method)."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q1, q2, q3


def spread(values: Sequence[float]) -> float:
    """Interquartile distance as a share of the median."""
    q1, q2, q3 = quartiles(values)
    return (q3 - q1) / abs(q2)


def histogram_percentile(counts: Sequence[int], edges: Sequence[float], p: float) -> float:
    """The ``p``-th percentile of a bucketed histogram, interpolated
    geometrically inside its bucket.  ``counts[i]`` holds the samples in
    ``[edges[i], edges[i + 1])``; NaN when empty."""
    total = sum(counts)
    if total == 0:
        return float("nan")
    rank = p / 100.0 * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            lo, hi = edges[i], edges[i + 1]
            frac = (rank - cum) / c
            if lo <= 0:
                return lo + frac * (hi - lo)
            return lo * (hi / lo) ** frac
        cum += c
    return edges[-1]


def latency_edges(min_s: float, per_decade: int, n_buckets: int) -> List[float]:
    """Edges of the port's log-bucketed latency histogram layout
    (``utils/metrics.LatencyHistogram``: bucket 0 is underflow below
    ``min_s``, bucket i ≥ 1 covers [min·10^((i−1)/per), min·10^(i/per)),
    the last absorbs overflow)."""
    edges = [0.0]
    for i in range(1, n_buckets + 1):
        edges.append(min_s * 10 ** ((i - 1) / per_decade))
    edges.append(edges[-1] * 10 ** (1 / per_decade))
    return edges


def count_at(log: Sequence[Tuple[float, float]], t: float) -> float:
    """The count reached by host time ``t`` in a log of (time, running
    count) pairs in time order: the last entry at or before ``t``, 0
    before the first."""
    lo, hi = 0, len(log)
    while lo < hi:
        mid = (lo + hi) // 2
        if log[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    return log[lo - 1][1] if lo else 0.0


def window_rate(log: Sequence[Tuple[float, float]], t0: float, t1: float) -> float:
    """Work completed in the window [t0, t1] over the whole window."""
    return (count_at(log, t1) - count_at(log, t0)) / (t1 - t0)


def union_of_spans(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def merged_spans(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


# Chrome-trace categories of device work and of host launch calls, as the
# port's trace summary reads them.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
GRAPH_LAUNCH = "cudaGraphLaunch"


def launch_device_starts(events: Sequence[dict]) -> List[float]:
    """For each graph launch on the host, in launch order, the device start
    of the first record it issued (µs on the trace's clock); launches whose
    records the profiler lost are left out."""
    first: Dict[object, float] = {}
    launches = []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            c = e.get("args", {}).get("correlation")
            t = float(e["ts"])
            if c not in first or t < first[c]:
                first[c] = t
        elif cat in HOST_API_CATS and e.get("name", "").startswith(GRAPH_LAUNCH):
            launches.append((float(e["ts"]), e.get("args", {}).get("correlation")))
    return [first[c] for _, c in sorted(launches, key=lambda x: x[0]) if c in first]


def reduce_trace(events: Sequence[dict], t_from_us: float, t_to_us: float,
                 top: int = 10) -> Optional[Dict]:
    """The device timeline of a Chrome trace between two device times (µs
    on the trace's clock): device records that start in [t_from, t_to),
    cut at t_to; their busy time (union) over the span t_to − t_from; the
    kernels that graph launches issued; time by device operation; and the
    idle gaps inside the span named by what the launching thread was doing
    (its shortest host call that covers the gap's middle).  None when no
    device record lies inside."""
    device, host = [], []
    launches: Dict[object, dict] = {}
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s = float(e["ts"])
            if t_from_us <= s < t_to_us:
                device.append(e)
        elif cat in HOST_CATS and "dur" in e:
            host.append(e)
            if cat in HOST_API_CATS and e.get("name", "").startswith(GRAPH_LAUNCH):
                launches[e.get("args", {}).get("correlation")] = e
    if not device:
        return None
    spans = [(float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0.0)), t_to_us))
             for e in device]
    busy = union_of_spans(spans)
    by_name: Dict[str, float] = {}
    count_by_name: Dict[str, int] = {}
    graph_kernels = 0
    for e in device:
        name = e.get("name", "")
        by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0.0))
        count_by_name[name] = count_by_name.get(name, 0) + 1
        if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launches:
            graph_kernels += 1
    # The launching thread: the one that issued the graph launches.
    tids: Dict[object, int] = {}
    for e in launches.values():
        tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    learner_tid = max(tids, key=tids.get) if tids else None
    mine = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
                  for e in host if e.get("tid") == learner_tid)
    gaps: Dict[str, float] = {}
    edges = [(t_from_us, t_from_us)] + merged_spans(spans) + [(t_to_us, t_to_us)]
    active: list = []   # heap of (end, duration, name): host calls begun by the gap
    j = 0
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 <= e0:
            continue
        mid = (e0 + s1) / 2
        while j < len(mine) and mine[j][0] <= mid:
            heapq.heappush(active, (mine[j][1], mine[j][1] - mine[j][0], mine[j][2]))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = min(active, key=lambda a: a[1])[2] if active \
            else "no host call on the launching thread"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0)
    return {
        "device_records": len(device),
        "busy_us": busy,
        "span_us": t_to_us - t_from_us,
        "graph_kernels": graph_kernels,
        "by_name_us": by_name,
        "count_by_name": count_by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: kv[1], reverse=True)[:top],
    }
