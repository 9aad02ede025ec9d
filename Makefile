# Local CI gate (same steps as .github/workflows/tests.yml).
#   make ci      - tests + multichip dryrun + CLI golden block
#   make test    - test suite only
#   make bench   - headline benchmark on the current backend
#   make docs    - executable-docs check (docs snippets run as tests)
#   make docs-html - static HTML documentation build (docs/_build)
#   make package - build sdist+wheel, install the wheel into a CLEAN
#                  venv, run the console script, assert the golden block
#                  (proves C26 installability; reference setup.cfg:41-46)

PY ?= python

.PHONY: ci test dryrun cli-golden bench docs docs-html package

test:
	$(PY) -m pytest tests/ -q

dryrun:
	JAX_PLATFORMS=cpu $(PY) __graft_entry__.py dryrun 8

cli-golden:
	rm -f /tmp/muse_psfr_ci_run.log
	JAX_PLATFORMS=cpu $(PY) -m muse_psfr_tpu --no-color \
	    --values 1,0.7,25 --logfile /tmp/muse_psfr_ci_run.log
	grep -q "FWHM 0.85 0.73 0.62" /tmp/muse_psfr_ci_run.log
	grep -q "BETA 2.73 2.55 2.23" /tmp/muse_psfr_ci_run.log

docs:
	$(PY) -m pytest tests/test_docs_examples.py -q

docs-html:
	$(PY) docs/build.py

# --no-isolation: the build env (setuptools>=64) is already present and
# the sandbox has no network.  The package itself installs ONLY from the
# built wheel (--no-deps --no-index); its jax/numpy/scipy deps resolve
# from the invoking interpreter's site-packages via PYTHONPATH (the
# invoking python may itself be a venv, so --system-site-packages alone
# would miss them), and JAX_PLATFORMS=cpu keeps the run on the CPU
# backend.
package:
	rm -rf dist /tmp/muse_psfr_pkg_venv /tmp/muse_psfr_pkg_run.log
	$(PY) -m build --no-isolation
	$(PY) -m venv /tmp/muse_psfr_pkg_venv
	/tmp/muse_psfr_pkg_venv/bin/pip install --no-deps --no-index \
	    --force-reinstall dist/muse_psfr_tpu-*.whl
	cd /tmp && JAX_PLATFORMS=cpu \
	    PYTHONPATH=$$($(PY) -c "import numpy, os; \
	        print(os.path.dirname(os.path.dirname(numpy.__file__)))") \
	    /tmp/muse_psfr_pkg_venv/bin/muse-psfr --no-color \
	    --values 1,0.7,25 --logfile /tmp/muse_psfr_pkg_run.log
	grep -q "FWHM 0.85 0.73 0.62" /tmp/muse_psfr_pkg_run.log
	grep -q "BETA 2.73 2.55 2.23" /tmp/muse_psfr_pkg_run.log
	@echo "package gate passed"

ci: test dryrun cli-golden
	@echo "CI gate passed"

bench:
	$(PY) bench.py
