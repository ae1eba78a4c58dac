"""Box geometry, anchors, NMS and the fused YOLO postprocess."""
