# Developer entry points. The native server builds via csrc/Makefile.

PYTEST_ENV = env JAX_PLATFORMS=cpu

.PHONY: test-smoke test server

# Fast pre-commit gate (~2 min on CPU): unit-test modules + a minimal
# end-to-end slice. Run this before EVERY commit; the full suite before
# anything performance- or pipeline-shaped ships. Depends on the native
# build (test_io_viz asserts libhessio.so is loadable; it builds in ~2 s)
# so the gate is green on a fresh checkout.
test-smoke: server
	$(PYTEST_ENV) python -m pytest tests/ -m smoke -q

# Full suite, 4 parallel pytest processes (~11 min; one process is >20
# min of non-shared jit compiles).
test:
	bash scripts/run_tests_parallel.sh 4

server:
	$(MAKE) -C csrc
