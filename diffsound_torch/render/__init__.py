"""Differentiable render layer of the joint image + audio task.

Counterpart of `diffsound_tpu/render/`: PBR BSDFs as plain functions
(autograd gives their backward), a chunked z-buffer rasterizer with an
analytic-barycentric differentiable resolve and a soft-coverage channel,
and a split-sum environment light whose pre-integrations are constant
linear operators on the trainable cubemap.  Everything is plain PyTorch;
the render runs in float32 whatever the caller's dtype."""
