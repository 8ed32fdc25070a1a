"""One run of one cell: set-up, the measured window, the comparison.

Set-up (``setup_s``, from process start to the window's start): the
cell's requests are drawn from the seed, the weights are made on the
device from the seed, the port is built through its loading entries and
its server started and warmed (``system.py``), and two rounds of
warm-up requests from outside the window's traffic go through the whole
HTTP path.  The window: the mix's generator drives ``POST /consensus``
for ``seconds``, and the window closes then, or, where the generator
drains (``"close": "drain"`` in an open-loop mix), once every request
due in those seconds has been answered; with ``trace`` the profiler
covers it.  Then the device's peak memory is read, the server is
stopped and the program's state freed, and the reference judges a
sample of the answers (``check.py``) from the weights in the form the
configuration's family gives them (``reference_state``)."""

from __future__ import annotations

import gc
import http.client
import math
import threading
import time
from dataclasses import dataclass

from . import check, spec, weights
from .readings import Readings
from .system import System, concurrency, package_dir
from .trace import Trace, port_kernel_names
from .traffic.requests import Request, RequestSource, model_texts

WARMUP_ROUNDS = 2
# the warm-up requests' client ids, outside any window's
WARMUP_CLIENT = 1_000_000


@dataclass
class Record:
    request: Request
    due: float
    sent: float
    done: float
    status: int
    body: bytes


class Session:
    """What a traffic generator drives: connections, requests, the
    window and the records."""

    def __init__(self, port: int, path: str, source: RequestSource,
                 prebuilt: list, seconds: float, grace_s: float,
                 on_open=None, on_close=None):
        self.port, self.path = port, path
        self.source, self.prebuilt = source, prebuilt
        self.seconds, self.grace_s = seconds, grace_s
        self.on_open, self.on_close = on_open, on_close
        self.records = []
        self.lock = threading.Lock()
        # window_end: when the traffic stops; closed_at: when the window
        # closed, the same unless the generator drained past it
        self.window_start = self.window_end = self.closed_at = math.inf
        self.opened_at = None

    def connect(self):
        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=self.grace_s + 600)

    def post(self, conn, req: Request) -> tuple:
        conn.request("POST", self.path, body=req.body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()

    def request(self, client: int, index: int) -> Request:
        rows = self.prebuilt[client] if client < len(self.prebuilt) else []
        if index < len(rows):
            return rows[index]
        return self.source.request(client, index)

    def open_window(self) -> None:
        if self.on_open is not None:
            self.on_open()
        self.opened_at = time.time()
        self.window_start = time.perf_counter()
        self.window_end = self.window_start + self.seconds

    def close_window(self, drained: bool = False) -> None:
        """Returns at the window's end, after the close hook; with
        ``drained`` the generator has waited for every request it sent,
        and the window closes now."""
        if drained:
            self.closed_at = time.perf_counter()
        else:
            wait = self.window_end - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.closed_at = self.window_end
        if self.on_close is not None:
            self.on_close()

    def record(self, req, due, sent, done, status, body) -> None:
        with self.lock:
            self.records.append(Record(req, due, sent, done, status, body))


def warm(system, mix: dict, source: RequestSource) -> None:
    """Rounds of as many concurrent requests as the mix can have in
    flight, from outside the window's traffic, through the whole HTTP
    path."""
    clients = concurrency(mix)
    failures = []

    def one(c: int, k: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", system.port,
                                          timeout=600)
        try:
            req = source.request(WARMUP_CLIENT + c, k)
            conn.request("POST", mix["path"], body=req.body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                failures.append(resp.status)
        finally:
            conn.close()

    for k in range(WARMUP_ROUNDS):
        threads = [threading.Thread(target=one, args=(c, k))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if failures:
        raise RuntimeError(f"warm-up requests failed: {failures}")


def percentile(values: list, q: float) -> float:
    """Nearest rank: the smallest value with at least q of the values at
    or under it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, process_start: float, quantize: str = "none",
             grace_s: float = 60.0, log=print) -> dict:
    """The result line's fields for one run (``checks`` last)."""
    import torch

    cfg, mix = cell.cfg, cell.mix
    family = spec.family(cfg["family"])
    dtype = getattr(torch, cfg["serving_dtype"])
    t0 = time.perf_counter()
    source = RequestSource(mix, seed)
    prebuilt = source.prebuilt(concurrency(mix),
                               int(mix["prebuild_per_client"]))
    t1 = time.perf_counter()
    state = weights.make_state(cfg, seed, device, dtype)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    system = System(cfg, mix, state, device, quantize=quantize)
    t3 = time.perf_counter()
    warm(system, mix, source)
    t4 = time.perf_counter()
    load, serve, capture = system.setup_parts
    log(f"setup: to here {time.time() - process_start - (t4 - t0):.3f} s, "
        f"requests {t1 - t0:.3f} s, weights {t2 - t1:.3f} s, port loader "
        f"{load:.3f} s, server {serve:.3f} s, graph captures "
        f"{capture:.3f} s "
        f"({len(system.warmup)} buckets), warm-up requests {t4 - t3:.3f} s")

    tracer = Trace(device) if trace else None
    counters = {}

    def on_open():
        counters["before"] = system.counters()
        if tracer is not None:
            tracer.start()

    def on_close():
        if tracer is not None:
            tracer.stop()
        counters["after"] = system.counters()

    session = Session(system.port, mix["path"], source, prebuilt, seconds,
                      grace_s, on_open, on_close)
    drive = spec.generator(mix["generator"]).drive
    gen_stats = drive(mix, session)
    setup_s = session.opened_at - process_start
    log(f"generator: {gen_stats}")

    closed = session.closed_at
    window_s = closed - session.window_start
    records = list(session.records)
    in_window = [r for r in records if r.sent < closed]
    answered = [r for r in records if r.status == 200 and r.done <= closed]
    latencies = [1e3 * (r.done - r.due) for r in answered]
    failed = (sum(r.status != 200 for r in records)
              + gen_stats.get("stuck_clients", 0))
    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else 0)
    count = torch.cuda.device_count() if device == "cuda" else 1

    out = {"correct": False, "attempted": len(in_window) + gen_stats.get(
        "stuck_clients", 0), "failed": failed, "metrics": {}}
    device_info = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                 else "cpu"),
        "count": cell.chips if device == "cuda" else count,
        "memory_peak_bytes": int(peak),
    }
    if not trace:
        values = {
            "answers_per_s": len(answered) / window_s,
            "p50_ms": percentile(latencies, 0.5) if latencies else None,
            "p95_ms": percentile(latencies, 0.95) if latencies else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                out["metrics"][m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    else:
        digest = tracer.digest()
        tok = check.reference_tokenizer(cfg)
        lengths = [[len(tok.encode(t, family.max_tokens(cfg)))
                    for t in model_texts(r.request)] for r in answered]
        readings = Readings(
            cfg=cfg, mix=mix, window_s=window_s, completed=answered,
            latencies_ms=latencies, lengths=lengths,
            before=counters["before"], after=counters["after"],
            trace=digest,
            port_kernels=port_kernel_names(package_dir(spec.HERE.parent)))
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(readings)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        device_info["busy_s"] = digest["busy_s"]
        device_info["window_s"] = digest["window_s"]
        out["breakdown"] = digest["breakdown"]
    out["device"] = device_info
    log(f"window: {len(answered)} answered in {window_s:.3f} s, "
        f"{len(in_window)} sent, {failed} failed, "
        f"{len(records) - len(answered)} answered after the close or "
        "failed")

    # the reference runs once the program's state is freed
    system.close()
    del system
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t5 = time.perf_counter()
    ref_state = family.reference_state(cfg, state, device)
    del state
    verdict = check.compare(cfg, mix, answered, ref_state, seed, device,
                            failed)
    log(f"check: {time.perf_counter() - t5:.3f} s")
    out["correct"] = verdict["correct"]
    out["checks"] = verdict["checks"]
    out["check_stats"] = verdict["extra"]
    return out
