"""Host-side utilities of the port (``twixt_for_open_spiel_tpu/utils``).

  serialization.py  history replay of game states (``serialize_state``,
                    ``deserialize_state``), snapshots of tensor trees
                    (``save_pytree``, ``load_pytree``) and training
                    checkpoints (``save_training``, ``restore_training``)
  profiling.py      ``Throughput``, ``trace`` and ``annotate`` on
                    ``torch.profiler``
"""
