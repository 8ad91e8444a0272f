"""Marks the JAX package's gradient cases that take minutes each as slow.

pytest.ini's `-m "not slow"` then leaves them out of the default run;
run them with

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_gradients.py \
        tests/test_surrogate.py -p xdist -n 6 --dist load

They check only the JAX reference package. tests/test_torch_diff.py holds
the port's differentiable path on their scenes and tolerances, and
tests/test_torch_parallel.py checks that this list marks exactly these
cases.
"""

import pytest

# Seconds of each on an 8-core Intel Xeon CPU under
# tests/ -m 'not slow' -p xdist -n 6 --dist loadfile.
SLOW_CASES = (
    "tests/test_gradients.py::test_albedo_gradient_matches_fd",  # 255 s
    "tests/test_gradients.py::test_solid_texture_gradient_matches_fd",  # 146 s
    "tests/test_gradients.py::test_emission_gradient_matches_fd",  # 203 s
    "tests/test_gradients.py::test_background_gradient_matches_fd",  # 162 s
    "tests/test_gradients.py::test_albedo_gradient_matches_fd_flash",  # 278 s
    "tests/test_gradients.py::test_fuzz_gradient_matches_fd_flash",  # 251 s
    "tests/test_gradients.py::test_flash_gradient_matches_brute_gradient",  # 592 s
    "tests/test_gradients.py::test_fuzz_gradient_matches_fd",  # 184 s
    "tests/test_gradients.py::test_ior_gradient_matches_fd",  # 156 s
    "tests/test_surrogate.py::test_render_ior_gradient_includes_choice_term",  # 355 s
)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in SLOW_CASES:
            item.add_marker(pytest.mark.slow)
