#!/usr/bin/env bash
# Run the test suite in N parallel pytest processes (default 4).
#
# One process takes >20 min: almost all of it is jit compiles, which
# don't share a cache across tests but do parallelize perfectly. The
# split is round-robin by file so each subset gets a mix of heavy
# (pipeline/sfm) and light (unit) modules.
#
# Usage: scripts/run_tests_parallel.sh [N] [extra pytest args...]
# Logs land in /tmp/pytest_subset_<i>.log; exit code is non-zero if any
# subset fails.
set -u
cd "$(dirname "$0")/.."
N="${1:-4}"
shift || true

mapfile -t FILES < <(ls tests/test_*.py)
declare -a SUBSET
for i in "${!FILES[@]}"; do
    idx=$((i % N))
    SUBSET[$idx]="${SUBSET[$idx]:-} ${FILES[$i]}"
done

pids=()
for i in $(seq 0 $((N - 1))); do
    # shellcheck disable=SC2086
    env JAX_PLATFORMS=cpu \
        python -m pytest ${SUBSET[$i]} -q --durations=25 "$@" \
        > "/tmp/pytest_subset_$i.log" 2>&1 &
    pids+=($!)
done

rc=0
for i in "${!pids[@]}"; do
    if ! wait "${pids[$i]}"; then
        rc=1
        echo "subset $i FAILED (/tmp/pytest_subset_$i.log):"
        tail -15 "/tmp/pytest_subset_$i.log"
    fi
done
for i in $(seq 0 $((N - 1))); do
    tail -1 "/tmp/pytest_subset_$i.log" | sed "s/^/subset $i: /"
done
exit $rc
