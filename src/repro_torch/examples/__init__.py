"""The reference's examples as the port's entry points.

  quickstart     -- the paper's reduction as a library, then tiny olmo-1b
                    trained with every reduction of its step on the MMAs
  serve_batched  -- batched greedy serving on two cache disciplines: a
                    dense arch's KV cache and the SSM's O(1) state
  train_100m     -- llama-110m (12 x 768) trained 300 steps of 8 x 512

Each has ``main(argv)`` and runs on the GPU unless given ``--device cpu``;
with no GPU and no ``--device`` it raises. ``launch.reduce_demo`` is the
port of ``examples/reduce_demo.py``.

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.serve_batched [--device cpu]
  python -m repro_torch.examples.train_100m [--smoke] [--device cpu]
"""
