# Shared setup for demo scripts. Source, don't execute.
#
# Copies the needed reference images into a writable work dir (the demo
# data dir may be read-only, and `hess` writes <img>.sift next to each
# input, matching hessgpucmd.cpp:70-80).
set -e
DATA="${1:-${HESSGPU_REFERENCE_DIR:?pass the data dir as \$1 or set HESSGPU_REFERENCE_DIR}/data}"
HERE="$(cd "$(dirname "${BASH_SOURCE[1]}")/.." && pwd)"
WORK="${DEMO_WORK:-/tmp/hess_demos}/$(basename "${BASH_SOURCE[1]}" .sh)"
mkdir -p "$WORK"
export PYTHONPATH="$HERE${PYTHONPATH:+:$PYTHONPATH}"
# JAX runs on its default backend (the GPU where there is one); set
# JAX_PLATFORMS=cpu to run a demo on the host.

hess() {
    python -m hessgpu_tpu.cli.hess "$@"
}

fetch() {  # fetch <name>... -> copies into $WORK, echoes local paths
    for n in "$@"; do
        cp -n "$DATA/$n" "$WORK/$n" 2>/dev/null || true
        echo "$WORK/$n"
    done
}
