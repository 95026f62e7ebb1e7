"""Closed-loop HTTP load, run as a child process of the benchmark so that
its Python never contends for the server's interpreter lock. Standard
library only: it imports neither torch nor the program.

Protocol over its standard streams, one line each:
  in:  the job, JSON: {"url", "clients", "requests": [[path, body], ...],
       "seconds", "timeout"}
  out: "ready"
  in:  "go"
  out: "start <t0>"   (time.monotonic, the clock the parent shares)
  out: the result, JSON: {"records": [[index, client, t_send, t_done,
       status, response text], ...]}

Each client sends its next request when its previous one has returned,
taking the next unsent request of the one list that all clients share,
until t0 + seconds; requests in flight then run to their end. Times are client-side: from just before the
connection opens to the last byte of the response.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request


def _post(url: str, data: bytes, timeout: float):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")
    except (urllib.error.URLError, OSError) as e:
        return 0, f"{type(e).__name__}: {e}"


def run(job: dict, t0: float) -> list:
    requests = [(job["url"] + path, body.encode())
                for path, body in job["requests"]]
    deadline = t0 + float(job["seconds"])
    lock = threading.Lock()
    cursor = [0]
    records = []

    def client(cid: int) -> None:
        while True:
            with lock:
                if time.monotonic() >= deadline or cursor[0] >= len(
                        requests):
                    return
                i = cursor[0]
                cursor[0] += 1
            url, data = requests[i]
            t_send = time.monotonic()
            status, text = _post(url, data, float(job["timeout"]))
            t_done = time.monotonic()
            with lock:
                records.append([i, cid, t_send, t_done, status, text])

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(int(job["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sorted(records)


def main() -> int:
    job = json.loads(sys.stdin.readline())
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    t0 = time.monotonic()
    print(f"start {t0!r}", flush=True)
    records = run(job, t0)
    sys.stdout.write(json.dumps({"records": records}) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
