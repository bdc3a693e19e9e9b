# Convenience targets (the reference's CMake/Make role; the Python
# package itself needs no build step — only the native C API does).

.PHONY: all test capi capi-test capi-torch capi-torch-test bench examples clean

all: capi

test:
	python -m pytest tests/ -q

capi:
	$(MAKE) -C capi

capi-test: capi
	$(MAKE) -C capi test_host
	cd capi && FABBER_TPU_PLATFORM=cpu \
	  FABBER_TPU_PYTHONPATH="$(CURDIR):$$(python -c 'import site; print(site.getsitepackages()[0])')" \
	  ./test_host

# the port's C API (fabber_core_tpu_torch/capi/), built at first use
# into build/capi/<key>/; its C host on the CPU (DEVICE=cuda: the card)
capi-torch:
	python -c 'from fabber_core_tpu_torch import capi; print(capi.build_host())'

capi-torch-test:
	python -m fabber_core_tpu_torch.capi $(if $(DEVICE),$(DEVICE),cpu)

bench:
	python bench.py

examples:
	FABBER_TPU_PLATFORM=cpu PYTHONPATH=$(CURDIR) python examples/test_single.py

clean:
	$(MAKE) -C capi clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
