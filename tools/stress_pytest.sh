#!/bin/bash
# Run one pytest node in COPIES concurrent shells, RUNS times each, from a
# source tree's root, and count the runs that passed.  A test that passes
# alone but depends on timing fails under this load (8 x 6 on an 8-core
# host).  Logs and exit codes go under OUT.
#
#   tools/stress_pytest.sh <tree> <out dir> <copies> <runs> <test node>
#   tools/stress_pytest.sh . /tmp/stress 8 6 \
#       tests/test_torch_cluster_procs.py::test_global_mesh_spans_the_cluster
set -u
tree=$(cd "$1" && pwd); out=$2; copies=$3; runs=$4; node=$5
rm -rf "$out"; mkdir -p "$out"; out=$(cd "$out" && pwd)
cd "$tree"
for c in $(seq 0 $((copies - 1))); do
  ( for r in $(seq 0 $((runs - 1))); do
      timeout 300 env PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
        -p no:cacheprovider --basetemp="$out/tmp_${c}_${r}" "$node" \
        > "$out/log_${c}_${r}.txt" 2>&1
      echo "$c $r $?" >> "$out/rcs.txt"
    done ) &
done
wait
echo "$(grep -c ' 0$' "$out/rcs.txt") passed of $(wc -l < "$out/rcs.txt")"
