"""The benchmark of ``swiftllm_tpu_torch``: what ``run.py`` runs.

- ``spec``: ``BENCHMARK.json``, and the files a cell is made of, by name.
- ``traffic``: the one generator that every traffic file parametrises.
- ``weights``: a configuration's weights, drawn on the device from the seed.
- ``serve``: the engine's set-up and the measured window.
- ``trace``: the profiler over a window and what is read from its records.
- ``costs``: the card's peaks and the work a step's tokens ask for.
- ``stats``: percentiles and rates.
- ``check``: the comparison with the plain reference that decides
  ``correct``.
- ``guard``: the modules a run may not load.
"""
