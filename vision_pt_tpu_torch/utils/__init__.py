import torch

PromptType = str | list[str]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA device,
    and raises when there is none; the CPU only when the caller asks."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
