# cddp-tpu container: CPU JAX build that installs the package and runs the
# test suite (counterpart of the reference's Dockerfile:2-39, which builds
# the C++ tree and runs ctest; here the accelerator path is JAX/XLA, so the
# container needs no toolchain beyond g++ for the native host oracles).
FROM python:3.12-slim-bookworm

RUN apt-get update && DEBIAN_FRONTEND=noninteractive apt-get install -y --no-install-recommends \
        g++ \
        make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY . /app

# CPU jaxlib: the image is for CI / local parity runs. On an NVIDIA GPU
# host install jax[cuda12] instead (the package code is identical; platform
# selection is runtime).
RUN pip install --no-cache-dir "jax[cpu]>=0.4.30" numpy pytest \
    && pip install --no-cache-dir -e .

# Build the native C++ host oracles once so tests/test_native.py is covered.
RUN g++ -O3 -shared -fPIC native/cddp_host.cpp -o native/libcddp_host.so

ENV JAX_PLATFORMS=cpu
CMD ["python", "-m", "pytest", "tests/", "-q", "-m", "not slow"]
