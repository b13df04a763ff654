"""Video decode/encode (OpenCV, imported lazily) and synthetic scenes."""
