# Verify loop for the G-TRAC reproduction. Targets:
#   make test           tier-1 suite (the ROADMAP command)
#   make bench-routing  routing scaling bench -> BENCH_routing.json
#   make bench-serving  window-batched router bench -> BENCH_serving.json
#                       (FAILS unless batched >= 3x per-token loop at R=64)
#   make bench-sharding sharded vs monolithic anchor -> BENCH_sharding.json
#                       (FAILS unless composed-snapshot no-change path
#                        <= 2x monolithic at S=16; parity always asserted)
#   make bench-sync     gossip sync plane -> BENCH_sync.json
#                       (FAILS unless single-report delta wire bytes
#                        <= 10% of the full snapshot at N=1000 AND the
#                        relay lane's anchor bytes/round at 64 relay
#                        seekers <= the 8-seeker direct-push cost;
#                        seeker parity, post-heal convergence, and the
#                        ceil(log2 N)+2 relay convergence bound always
#                        asserted — --quick included)
#   make bench-control-plane
#                       process-backed anchor control plane ->
#                       BENCH_control_plane.json (FAILS unless 8 shard
#                       worker processes aggregate >= 1M heartbeats/s of
#                       batched fan-in; the kill-a-worker chaos lane —
#                       zero routing windows lost, ledger restore,
#                       composed-snapshot parity vs worker exports — and
#                       the FakeClock retry/backoff determinism lane are
#                       asserted every run, --quick included)
#   make bench-smoke    CI smoke lane: all five benches in --quick mode
#                       (tiny N/R, perf gates skipped; writes
#                        BENCH_*.quick.json, never the tracked JSONs —
#                        the serving bench's trace-overhead gate,
#                        tracer-on >= 0.95x tracer-off, runs even here)
#   make trace-demo     traced windowed serve (examples/edge_sim.py
#                       --trace): exports /tmp/edge_trace.jsonl,
#                       schema-validates it, prints the critical-path
#                       report, asserts the TTFT decomposition identity
#   make analyze        repo-specific AST invariant linter (repolint):
#                       python -m repro.analysis src/repro under the
#                       checked-in allow-list (repolint.json). Stdlib
#                       only — no installs needed; findings fail with
#                       file:line output
#   make analyze-torch  the same linter over the PyTorch port:
#                       python -m repro_torch.analysis src/repro_torch
#                       under repolint_torch.json
#   make lint           compile-check + `make analyze` + ruff (pyflakes
#                       fallback). The generic-linter half is a HARD
#                       dependency: fails if neither linter is installed —
#                       pip install -r requirements-dev.txt
#
# CI (.github/workflows/ci.yml) runs `make lint`, the tier-1 suite on
# Python 3.10 + 3.11, and `make bench-smoke` with BENCH_*.json uploaded
# as workflow artifacts.

PY        ?= python
PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH),)
export PYTHONPATH

.PHONY: test bench-routing bench-serving bench-sharding bench-sync \
	bench-control-plane bench-smoke trace-demo analyze analyze-torch lint

test:
	$(PY) -m pytest -x -q

bench-routing:
	$(PY) -m benchmarks.bench_scaling

bench-serving:
	$(PY) -m benchmarks.bench_serving

bench-sharding:
	$(PY) -m benchmarks.bench_sharding

bench-sync:
	$(PY) -m benchmarks.bench_sync

bench-control-plane:
	$(PY) -m benchmarks.bench_control_plane

trace-demo:
	$(PY) examples/edge_sim.py --trace /tmp/edge_trace.jsonl
	$(PY) -m repro.obs.export --validate /tmp/edge_trace.jsonl

bench-smoke:
	$(PY) -m benchmarks.bench_scaling --quick
	$(PY) -m benchmarks.bench_serving --quick
	$(PY) -m benchmarks.bench_sharding --quick
	$(PY) -m benchmarks.bench_sync --quick
	$(PY) -m benchmarks.bench_control_plane --quick

analyze:
	$(PY) -m repro.analysis src/repro

analyze-torch:
	$(PY) -m repro_torch.analysis src/repro_torch

lint: analyze
	$(PY) -m compileall -q src benchmarks tests examples
	@if $(PY) -c "import ruff" >/dev/null 2>&1; then \
	    $(PY) -m ruff check src benchmarks tests examples; \
	elif $(PY) -c "import pyflakes" >/dev/null 2>&1; then \
	    $(PY) -m pyflakes src benchmarks tests examples; \
	else \
	    echo "lint: no linter installed (ruff or pyflakes required);" \
	         "run: pip install -r requirements-dev.txt"; \
	    exit 1; \
	fi
