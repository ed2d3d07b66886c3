"""Host-side utilities of the port (``twixt_for_open_spiel_tpu/utils``).

  serialization.py  history replay of game states (``serialize_state``,
                    ``deserialize_state``), snapshots of tensor trees
                    (``save_pytree``, ``load_pytree``) and training
                    checkpoints (``save_training``, ``restore_training``)
  profiling.py      ``Throughput`` and ``trace`` on ``torch.profiler``;
                    ``annotate``, the span helper, a ``record_function``
                    while a profiler records and a shared no-op otherwise;
                    ``SPANS``, every span the package opens; ``SpanTrace``,
                    a profiler's events by span
  timing.py         ``device_ms`` and ``back_to_back_ms``: a short call's
                    time on the card, with CUDA events
"""
