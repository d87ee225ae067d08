"""paddle.check_import_scipy equivalent (reference: a Windows DLL-error
diagnostic around `import scipy`)."""


def check_import_scipy(os_name):
    if os_name == 'nt':
        try:
            import scipy.io  # noqa: F401
        except ImportError as e:
            if 'DLL load failed' in str(e):
                raise ImportError(
                    "Error: import scipy.io failed; please check your "
                    "Visual C++ runtime installation")
    return True
