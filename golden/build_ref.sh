#!/bin/bash
# Build the reference renderer as a golden-image oracle.
#
# The reference does not build/run as-is on Linux:
#  - std::powf is MSVC-only (shimmed by prelude.h);
#  - the std::thread arg struct is scoped inside the spawn loop and read
#    after scope exit (PathTracing.hpp:10-12) — AddressSanitizer-confirmed
#    stack-use-after-scope, segfaults under g++. We flip MULTITHREAD to 0,
#    which also selects the single-thread pixel-center math (the variant
#    without the double-c_off_v bug) that this renderer implements.
#  - main.cpp loads "veach_slight.obj" but the asset is "veach_sLight.obj"
#    (main.cpp:49) — fine on case-insensitive Windows, broken on Linux; the
#    staged model tree gets a lowercase copy.
#
# Everything reference-derived (sources, patched headers, model assets,
# and the built binaries' run directory) is STAGED into /tmp/ref_build;
# the binaries land in golden/ but are gitignored — only the .ppm oracle
# outputs and the tiny config files are tracked.
set -euo pipefail
cd "$(dirname "$0")"

STAGE=/tmp/ref_build
rm -rf "$STAGE"
mkdir -p "$STAGE"
cp -r /root/reference/include "$STAGE/include"
cp -r /root/reference/src "$STAGE/src"
cp -r /root/reference/model "$STAGE/model"
# case-sensitivity fix for the veach scene (main.cpp:49)
cp "$STAGE/model/veach_bdpt/veach_sLight.obj" \
   "$STAGE/model/veach_bdpt/veach_slight.obj"

# single-threaded build (see header comment)
sed -i 's/#define MULTITHREAD\t1/#define MULTITHREAD 0/' "$STAGE/include/global.hpp"
grep -q "MULTITHREAD 0" "$STAGE/include/global.hpp" || {
  echo "patch failed"; exit 1; }

FLAGS="-O2 -std=c++17 -fopenmp -include prelude.h -pthread"
g++ $FLAGS -I"$STAGE/include" -o ref_cornell_st "$STAGE/src/main_cornellBox.cpp"
g++ $FLAGS -I"$STAGE/include" -o ref_veach_st "$STAGE/src/main.cpp"

# ---- additional oracle builds (round 3) -------------------------------
# generic config-driven main (our own glue, golden/main_oracle.cpp) + an
# emissive quad asset it loads; enables MICROFACET_T / texture / bump
# scenes that exist only in the config grammar
cp main_oracle.cpp "$STAGE/src/main_oracle.cpp"
cat > "$STAGE/model/oracle_light.obj" <<'OBJ'
v -0.5 1.4 -0.5
v 0.5 1.4 -0.5
v 0.5 1.4 0.5
v -0.5 1.4 0.5
vn 0 -1 0
f 1//1 2//1 3//1
f 1//1 3//1 4//1
OBJ
g++ $FLAGS -I"$STAGE/include" -o ref_oracle "$STAGE/src/main_oracle.cpp"

# NEE-only build (MIS 0): pins the reference's !MIS branch
# (PathTracing.hpp:281-347) against our opts.mis=False estimator
STAGE2=/tmp/ref_build_nomis
rm -rf "$STAGE2"
cp -r "$STAGE" "$STAGE2"
sed -i 's/#define MIS\t1/#define MIS 0/' "$STAGE2/include/global.hpp"
grep -q "MIS 0" "$STAGE2/include/global.hpp" || { echo "MIS patch failed"; exit 1; }
g++ $FLAGS -I"$STAGE2/include" -o ref_cornell_nomis "$STAGE2/src/main_cornellBox.cpp"

# flagship-sample-count build (SPP 512): BASELINE.md's Cornell 512 spp
# row, rendered single-threaded at oracle-feasible resolution
STAGE3=/tmp/ref_build_spp512
rm -rf "$STAGE3"
cp -r "$STAGE" "$STAGE3"
sed -i 's/^int SPP = 64;/int SPP = 512;/' "$STAGE3/include/global.hpp"
grep -q "int SPP = 512;" "$STAGE3/include/global.hpp" || { echo "SPP patch failed"; exit 1; }
g++ $FLAGS -I"$STAGE3/include" -o ref_cornell_spp512 "$STAGE3/src/main_cornellBox.cpp"

echo "built ref_cornell_st ref_veach_st ref_oracle ref_cornell_nomis ref_cornell_spp512"
echo "run from $STAGE/src so ../model resolves to the staged assets, e.g.:"
echo "  (cd $STAGE/src && /root/repo/golden/ref_cornell_st /root/repo/golden/cornell_128.txt)"
