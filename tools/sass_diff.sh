#!/usr/bin/env bash
# Compare the machine code (SASS) that nvcc makes for kernel sources of two
# checkouts, on a machine with the CUDA toolkit:
#
#     tools/sass_diff.sh DIR_A DIR_B [SOURCE ...]
#
# SOURCE names a file of llm_inference_tpu_torch/csrc without its .cu
# (default: the five whole-step sources). Each is compiled for sm_90a with
# the flags of ops/kernels/_build.py to a cubin in both checkouts, and the
# line prints how many lines of `cuobjdump -sass` differ, kernel names aside
# (0: the same code, so a time difference between the two is noise).
set -euo pipefail
a=$1 b=$2
shift 2
sources=("$@")
[ ${#sources[@]} -gt 0 ] || sources=(fused_decode fused_decode_q fused_decode_stream fused_decode_tp fused_decode_q_tp)
nvcc=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)
cuobjdump=$(dirname "$nvcc")/cuobjdump
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
for src in "${sources[@]}"; do
  for side in a b; do
    dir=${!side}
    "$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin \
      -o "$out/$side.cubin" "$dir/llm_inference_tpu_torch/csrc/$src.cu"
    # a kernel's mangled name carries a hash of its file's path: compare the code
    "$cuobjdump" -sass "$out/$side.cubin" | grep -v -e '^\s*$' -e 'Function :' > "$out/$side.sass"
  done
  echo "$src: $(wc -l < "$out/a.sass") and $(wc -l < "$out/b.sass") SASS lines," \
    "$( (diff "$out/a.sass" "$out/b.sass" || true) | grep -c '^[<>]') differ"
done
