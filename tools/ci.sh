#!/usr/bin/env bash
# CI entry point: everything a clean checkout needs to be trusted.
#
#   tools/ci.sh          # fast suite + golden reproduction (~12 min)
#   tools/ci.sh --full   # + the interpret-mode Pallas kernel suite (~+4 min)
#
# All stages run on CPU (float64, 8 virtual devices; the GPU kernels in the
# Pallas interpreter). On a GPU, run `python chip_smoke.py` instead.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== sdist/wheel build =="
python -m pip wheel --no-deps --no-build-isolation -w /tmp/lws_jax_wheel . \
    >/dev/null 2>&1 || python -m pip wheel --no-deps -w /tmp/lws_jax_wheel .
ls /tmp/lws_jax_wheel/lws_jax-*.whl

echo "== clean-venv wheel install smoke =="
# install the just-built wheel into a fresh venv (system-site-packages so
# jax/numpy/pytest resolve without network) and run a golden-backed test
# subset AGAINST THE INSTALLED PACKAGE (cwd outside the repo, so `import
# lws_jax` cannot fall back to the checkout), plus the oracle-skip path a
# compiler-less user would hit (LWS_DISABLE_ORACLE exercises it
# deliberately; the skips must be visible, not silent)
VENV=$(mktemp -d)/venv
python -m venv "$VENV"
# make the invoking interpreter's deps (jax/numpy/pytest) resolvable in the
# fresh venv via a .pth (works even when the CI python is itself a venv,
# where --system-site-packages would point at the wrong base)
python -c "import sysconfig; print(sysconfig.get_paths()['purelib'])" \
    > "$("$VENV/bin/python" -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")/_host_deps.pth"
"$VENV/bin/pip" install --no-deps --no-index -q /tmp/lws_jax_wheel/lws_jax-*.whl
REPO=$(pwd)
(cd /tmp \
 && "$VENV/bin/python" -c "import lws_jax, os; \
p = os.path.dirname(lws_jax.__file__); \
assert p.startswith('$VENV'), f'imported {p}, not the installed wheel'; \
print('installed import OK:', p)" \
 && "$VENV/bin/python" -m pytest "$REPO/tests/test_windows.py" \
        "$REPO/tests/test_stft.py" -q -p no:cacheprovider \
 && echo "-- oracle-skip path (no compiler scenario) --" \
 && LWS_DISABLE_ORACLE=1 "$VENV/bin/python" -m pytest \
        "$REPO/tests/test_oracle.py" -q -p no:cacheprovider -rs \
        | tee /tmp/lws_jax_oracle_skip.out \
 && grep -q "skipped" /tmp/lws_jax_oracle_skip.out)
rm -rf "$(dirname "$VENV")"

echo "== golden reproduction (reference C core, bit-for-bit) =="
python tools/make_goldens.py --check

echo "== fast suite (CPU, x64, 8 virtual devices) =="
python -m pytest tests/ -q --ignore=tests/test_pallas.py

if [[ "${1:-}" == "--full" ]]; then
    echo "== GPU kernels, Pallas interpret mode =="
    python -m pytest tests/test_pallas.py -q -p xdist -n 4 \
        || python -m pytest tests/test_pallas.py -q
fi

echo "CI OK"
