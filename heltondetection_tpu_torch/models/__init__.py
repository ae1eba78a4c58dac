"""YOLOv5 network: conv blocks, CSPDarknet, PAFPNv5 and the detector."""
