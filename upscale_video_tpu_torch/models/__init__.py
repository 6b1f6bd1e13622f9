"""Model layer: ncnn .param/.bin -> torch modules running the port's kernels."""
