import os
import sys

# the checkout's root, so that ``gpubench`` and the port import
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
