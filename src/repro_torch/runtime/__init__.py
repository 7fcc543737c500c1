"""What the serving engine and the launch layer's steps share on the
device: CUDA graph capture and replay (``graphs``)."""
