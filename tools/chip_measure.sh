#!/usr/bin/env bash
# The card measurements PERF.md reports for the CLDDP fleet, on one GPU:
# chip_smoke.py, the kernel-vs-XLA A/B (10 alternating rounds) and the
# trace probe, one process after another (one JAX process holds the card
# at a time). Runs from the checkout that holds this script; writes
# smoke.out/.err, ab.jsonl/.err and trace_probe.json/probe.err to OUT_DIR.
#
#   bash tools/chip_measure.sh [OUT_DIR]   # default <checkout>/chiprun_out
set -u
root="$(cd "$(dirname "$0")/.." && pwd)"
out="$(mkdir -p "${1:-$root/chiprun_out}" && cd "${1:-$root/chiprun_out}" && pwd)"
cd "$root"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python chip_smoke.py > "$out/smoke.out" 2> "$out/smoke.err"
echo "chip_smoke rc=$?"
python tools/clddp_kernel_ab.py --rounds 10 > "$out/ab.jsonl" 2> "$out/ab.err"
echo "clddp_kernel_ab rc=$?"
python tools/trace_probe.py --out "$out/trace_probe.json" \
    > /dev/null 2> "$out/probe.err"
echo "trace_probe rc=$?"
tail -n 2 "$out/smoke.out"
