"""Mean device-stream time of ``image_to_latent``, the VAE encode of a render (CUDA events, ms)."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms(run, "vae_encode")
