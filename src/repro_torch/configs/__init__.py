"""Architecture config modules of the port (``config()``, ``reduced()``,
``one_card_run()``), resolved through :mod:`repro_torch.api.registry`."""
