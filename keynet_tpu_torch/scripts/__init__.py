"""The port of the three ``scripts/`` programs that users run:

    python -m keynet_tpu_torch.scripts.attack_bundle         (scripts/attack_bundle.py)
    python -m keynet_tpu_torch.scripts.run_fiberbundle_fig6  (scripts/run_fiberbundle_fig6.py)
    python -m keynet_tpu_torch.scripts.serve --snapshot NPZ  (scripts/serve_vgg_orth.py)

Each has a function that returns its results as a dict, a ``main()`` and a
``--device`` flag (default cuda).  ROADMAP.md maps every other script of
``scripts/`` to its counterpart in the port.
"""
