"""Host I/O of the port: image files without cv2 or PIL (images.py)."""
