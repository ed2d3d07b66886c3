"""Host-side utilities of the port (``twixt_for_open_spiel_tpu/utils``).

  serialization.py  history replay of game states (``serialize_state``,
                    ``deserialize_state``), snapshots of tensor trees
                    (``save_pytree``, ``load_pytree``) and training
                    checkpoints (``save_training``, ``restore_training``)
  profiling.py      ``Throughput``, ``trace`` and ``annotate`` on
                    ``torch.profiler``
  timing.py         ``device_ms`` and ``back_to_back_ms``: a short call's
                    time on the card, with CUDA events
"""
