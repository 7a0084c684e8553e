"""yoho_tpu_torch: the PyTorch and CUDA port of yoho_tpu for NVIDIA GPUs."""


def __getattr__(name):
    # Lazy: `import yoho_tpu_torch` loads no model code until a loader is
    # actually used.
    if name == "load_transcriber":
        from yoho_tpu_torch.load import load_transcriber

        return load_transcriber
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
