"""Fixed-rate open loop: request i is due at ``i / rate_per_s`` seconds
into the window, whether or not earlier ones were answered; ``senders``
threads take the due requests in order, each on its own keep-alive
connection.  A request's latency runs from when it was due, so a stall
also charges the requests queued behind it.  The generator reports how
late it ran: each send's delay past its due time.

With ``"close": "drain"`` the window closes only when every request due
in it has been answered: its work is then fixed by the schedule, and a
rate over it does not hang on where the close falls among the answers
that a batched dispatch returns together."""

from __future__ import annotations

import threading
import time


def drive(mix: dict, session) -> dict:
    rate = float(mix["rate_per_s"])
    drain = mix.get("close") == "drain"
    senders = int(mix.get("senders", 32))
    lock = threading.Lock()
    state = {"next": 0}
    late = []
    start = threading.Barrier(senders + 1)

    def sender(s: int) -> None:
        conn = session.connect()
        try:
            start.wait()
            while True:
                with lock:
                    i = state["next"]
                    state["next"] += 1
                due = session.window_start + i / rate
                if due >= session.window_end:
                    return
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                # request i is slot i % senders' (i // senders)-th, so
                # the bodies do not depend on which thread sends them
                req = session.request(i % senders, i // senders)
                sent = time.perf_counter()
                late.append(sent - due)
                try:
                    status, body = session.post(conn, req)
                except OSError as exc:
                    status, body = -1, repr(exc).encode()
                    conn.close()
                    conn = session.connect()
                session.record(req, due=due, sent=sent,
                               done=time.perf_counter(), status=status,
                               body=body)
        finally:
            conn.close()

    threads = [threading.Thread(target=sender, args=(s,), daemon=True,
                                name=f"bench-sender-{s}")
               for s in range(senders)]
    for t in threads:
        t.start()
    session.open_window()
    start.wait()
    if not drain:
        session.close_window()
    deadline = session.window_end + session.grace_s
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    if drain:
        session.close_window(drained=True)
    late_ms = sorted(x * 1e3 for x in late)
    return {"senders": senders, "rate_per_s": rate,
            "late_p50_ms": late_ms[len(late_ms) // 2] if late_ms else None,
            "late_max_ms": late_ms[-1] if late_ms else None,
            "stuck_clients": sum(t.is_alive() for t in threads)}
