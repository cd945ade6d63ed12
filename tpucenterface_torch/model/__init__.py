"""NHWC-API torch model: MobileNetV2-class backbone -> FPN-lite neck -> CenterNet heads."""
