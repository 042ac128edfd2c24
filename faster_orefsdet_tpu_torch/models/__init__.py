"""nn.Modules of the detector (NCHW feature maps)."""
