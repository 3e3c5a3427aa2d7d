#!/bin/bash
# Reference demos/evaluation-box.bat: the golden-fixture configuration —
# DoG personality flags (-w 3 -fo -1 -loweo) on doc/evaluation/box.pgm,
# writing box.siftgpu-compatible output (see tests/test_golden_box.py).
source "$(dirname "$0")/_common.sh"
cp -n "${HESSGPU_REFERENCE_DIR:?set HESSGPU_REFERENCE_DIR}/doc/evaluation/box.pgm" "$WORK/"
hess -i "$WORK/box.pgm" -dog -w 3 -fo -1 -loweo -v 1 -o "$WORK/box.siftgpu"
echo "wrote $WORK/box.siftgpu"
