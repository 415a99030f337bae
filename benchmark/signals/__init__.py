"""Input signals, one module per name a traffic mix's ``signal`` gives:
``make(generator, channels, samples, device) -> float32 [channels, samples]``
on ``device``, drawn from the ``torch.Generator`` passed in."""
