#!/usr/bin/env bash
# The port's tools/run_campaign256.sh: the 200-iteration production
# campaign at 256^3 elements (257^3 nodes, 50.9M dof) on one GPU through
# the port's fused driver, with the JAX script's flags, then the same
# summary (tools/summarize_run.py) and the same gate, tools/compare_history.py
# (fx rtol 1e-3 at every iteration the two histories share), against the
# JAX package's own run of the campaign's flags on the CPU,
# docs/jax_cpu_history_257x257x257_campaign.npz.  The JAX campaign's TPU
# history, docs/golden_history_257x257x257.npz, is not the reference: the
# JAX package on the CPU and the port part from it from iteration 1's
# design update on (ROADMAP queue 3); its gap is printed on a line of its
# own and gates nothing.  Exits with the gate's code, or with the run's if
# the run fails.
#
# Usage: bash tools/torch_run_campaign256.sh [workdir [CLI flags...]]
#   workdir defaults to runs/torch_prod256 (listed in .gitignore); the JAX
#   campaign's runs/prod256 is refused.  Flags after the workdir follow
#   the campaign's (a later flag wins), e.g. `-device cpu` or `-maxItr 20`.
#   GOLDEN=<history.npz> gates against another history.
#
# The reference history: `JAX_PLATFORMS=cpu python -m topopt_in_petsc_tpu
# -nx 257 -ny 257 -nz 257 -nlvls 5 -fused 1 -output_dat 0
# -output_cadence_vtu 0 -maxItr 3 -workdir DIR` writes DIR/history.npz
# (PERF.md section 2: its time and memory).
#
# Disk: the run writes ~23 GB (the .dat: a 1.55 GB mesh and 21 datasets
# of 0.40 GB, iterations 1-10, every 20th and the final dump; a 0.6 GB
# restart pair 21 times, two pairs kept by the A/B flip) and keeps ~11.5
# GB.  Point the workdir at a file system that takes that, e.g.
# /dev/shm/campaign256 on a host with the memory for it (the disk of
# some GPU hosts takes only ~45 GiB of writes per job).
set -u
REPO="$(cd "$(dirname "$0")/.." && pwd -P)"
WORKDIR="$(realpath -m "${1:-$REPO/runs/torch_prod256}")"
shift $(( $# > 0 ? 1 : 0 ))
case "$WORKDIR/" in
    "$REPO/runs/prod256/"*)
        echo "refusing $WORKDIR: it holds the JAX campaign" >&2
        exit 2 ;;
esac
mkdir -p "$WORKDIR"
GOLDEN="$(realpath -m "${GOLDEN:-$REPO/docs/jax_cpu_history_257x257x257_campaign.npz}")"
TPU_GOLDEN="$REPO/docs/golden_history_257x257x257.npz"
cd "$REPO"
rm -f "$WORKDIR/history.npz"
echo "campaign (port): 257^3, nlvls=5, maxItr=200 $* -> $WORKDIR" >&2
python -m topopt_in_petsc_tpu_torch \
    -nx 257 -ny 257 -nz 257 -nlvls 5 -maxItr 200 \
    -fused 1 -output_dat 1 -output_cadence_vtu 0 \
    -workdir "$WORKDIR" "$@" \
    2>&1 | tee "$WORKDIR/run.log"
rc="${PIPESTATUS[0]}"
if [ "$rc" -ne 0 ]; then
    echo "the run exited $rc; no summary, no gate" >&2
    exit "$rc"
fi
python tools/summarize_run.py "$WORKDIR/run.log" | tee "$WORKDIR/summary.txt"
python tools/compare_history.py "$WORKDIR/history.npz" "$GOLDEN" \
    | tee "$WORKDIR/golden_gate.txt"
rc="${PIPESTATUS[0]}"
gap="$(python tools/compare_history.py "$WORKDIR/history.npz" "$TPU_GOLDEN" \
    | sed -n 's/^ *fx *//p')"
echo "TPU golden (not gated; $(basename "$TPU_GOLDEN")): fx ${gap:-not compared}"
exit "$rc"
