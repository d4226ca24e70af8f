"""``python -m audio_rag_tpu_torch.api [--host H] [--port P] [--config F]
[--env E] [--inline-worker]``: serve the API (see
:func:`audio_rag_tpu_torch.api.app.main`). Importing this module starts
nothing."""

from audio_rag_tpu_torch.api.app import main

if __name__ == "__main__":
    main()
