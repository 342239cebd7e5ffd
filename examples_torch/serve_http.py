"""HTTP serving demo on the port (``serving/server.py``).

Twin of ``examples/serve_http.py``: starts ``serve()``'s default engine
(the slot ``DecodeEngine``) behind the HTTP front, then acts as its own
client: concurrent blocking completions, one SSE streaming completion,
and a stats read.  Sampling draws from a ``torch.Generator`` seeded as
the JAX script seeds its key.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/serve_http.py
Point a real client at it with --port 8000 --hold.
"""
import argparse
import http.client
import json
import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--window", type=int, default=96)
    p.add_argument("--hold", action="store_true",
                   help="keep serving until Ctrl-C instead of exiting")
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    import torch

    from autodist_tpu_torch.models import resolve_device, transformer_lm
    from autodist_tpu_torch.serving import serve

    dev = resolve_device(args.device)
    system_prompt = list(range(40, 52))     # the shared cached prefix
    # pos_embed must hold prefix + a full window of request positions
    spec = transformer_lm(vocab_size=331, num_layers=2, num_heads=4,
                          head_dim=16, d_ff=128,
                          max_len=args.window + len(system_prompt) + 4,
                          seq_len=32)
    if params is None:
        params = spec.init(0, device=dev)
    srv = serve(spec, params, port=args.port, slots=args.slots,
                window=args.window, chunk=8,
                temperature=0.8, top_p=0.95,
                rng=torch.Generator(device=dev).manual_seed(7),
                prefix_tokens=system_prompt, device=dev)
    host, port = srv.address
    print(f"serving on http://{host}:{port}  "
          f"(POST /v1/completions, GET /v1/stats)")

    def post(path, body):
        c = http.client.HTTPConnection(host, port, timeout=300)
        c.request("POST", path, json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        out = json.loads(r.read())
        c.close()
        return r.status, out

    # Concurrent blocking completions (more than the slot count).
    rng = np.random.RandomState(0)
    outs = {}

    def issue(i):
        prompt = rng.randint(0, 331, rng.randint(2, 8)).tolist()
        # every other request: per-request greedy override + the shared
        # system-prompt prefix as cached context
        body = {"prompt_tokens": prompt,
                "max_new_tokens": int(rng.randint(4, 12))}
        if i % 2:
            body["temperature"] = 0.0
            body["use_prefix"] = True
        outs[i] = post("/v1/completions", body)

    threads = [threading.Thread(target=issue, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outs) == len(threads), \
        f"only {len(outs)}/{len(threads)} client threads completed"
    for i in sorted(outs):
        status, body = outs[i]
        assert status == 200, body
        print(f"  completion[{i}]: {len(body['new_tokens'])} new tokens "
              f"-> {body['new_tokens'][:8]}...")

    # One SSE streaming completion.
    c = http.client.HTTPConnection(host, port, timeout=300)
    c.request("POST", "/v1/completions",
              json.dumps({"prompt_tokens": [5, 9, 2],
                          "max_new_tokens": 12, "stream": True}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200, r.read()
    deltas = 0
    while True:
        line = r.readline()
        if not line:   # EOF: server closed without a done event
            print("  stream: closed early after "
                  f"{deltas} delta events")
            break
        line = line.strip()
        if line.startswith(b"data: "):
            ev = json.loads(line[6:])
            if ev.get("done"):
                if "tokens" in ev:
                    print(f"  stream: {deltas} delta events, final "
                          f"{len(ev['tokens'])} tokens")
                else:   # terminal timeout/cancelled event
                    print(f"  stream: terminated ({ev})")
                break
            deltas += 1
    c.close()

    st = post("/v1/cancel", {"id": 999})[1]
    print(f"  cancel unknown id -> cancelled={st['cancelled']}")
    c = http.client.HTTPConnection(host, port, timeout=60)
    c.request("GET", "/v1/stats")
    stats = json.loads(c.getresponse().read())
    c.close()
    print(f"  stats: served={stats['requests_served']} "
          f"completed={stats['completed']} "
          f"util={stats['slot_utilization']:.2f}")

    if args.hold:
        print("serving (Ctrl-C to stop) ...")
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
    srv.close()
    print("serve_http demo OK")
    return stats


if __name__ == "__main__":
    main()
