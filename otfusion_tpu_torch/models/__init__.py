"""Models: 3D ResNet backbone, attention block, OT fusion classifier."""
