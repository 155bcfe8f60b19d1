/**
 * eventql_tpu embedded server — the C server API
 * (reference: src/eventql/eventql.h:340-408 evql_server_*; the
 * reference's evqld.cc is itself a thin wrapper over this API).
 *
 * A C host links libevql_server.so, builds an evql_conf_t, and boots a
 * full server in-process: evql_server_init → evql_server_start →
 * evql_server_listen(kill_fd). The engine runs on an embedded CPython
 * interpreter (eventql_tpu_torch.server.embedded); when the host process
 * already runs Python (e.g. ctypes tests), the existing interpreter is
 * reused.
 *
 * Build: make -C native (libevql_server.so, links libpython).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdlib.h>
#include <string.h>

/* mirror of the client library's conf struct (native/evql_client.c) —
 * both live in separate .so files, so keep the layout in sync */
struct evql_conf_s {
  char** keys;
  char** vals;
  size_t n;
  size_t cap;
};
typedef struct evql_conf_s evql_conf_t;

struct evql_server_s {
  PyObject* pyserver;  /* eventql_tpu_torch.server.embedded.EmbeddedServer */
  char error[1024];
  char confbuf[1024];
  int started;
  int we_initialized_python;
};
typedef struct evql_server_s evql_server_t;

static void set_error(evql_server_t* s, const char* msg) {
  snprintf(s->error, sizeof(s->error), "%s", msg);
}

static void set_pyerror(evql_server_t* s) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject* str = PyObject_Str(value);
    if (str) {
      const char* msg = PyUnicode_AsUTF8(str);
      set_error(s, msg ? msg : "python error");
      Py_DECREF(str);
    }
  } else {
    set_error(s, "python error");
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

evql_server_t* evql_server_init(evql_conf_t* conf) {
  evql_server_t* s = (evql_server_t*)calloc(1, sizeof(evql_server_t));
  if (!s) return NULL;

  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    s->we_initialized_python = 1;
  }
  PyGILState_STATE g = PyGILState_Ensure();

  PyObject* confdict = PyDict_New();
  if (conf) {
    for (size_t i = 0; i < conf->n; i++) {
      PyObject* v = PyUnicode_FromString(conf->vals[i]);
      PyDict_SetItemString(confdict, conf->keys[i], v);
      Py_DECREF(v);
    }
  }

  PyObject* mod = PyImport_ImportModule("eventql_tpu_torch.server.embedded");
  if (!mod) {
    set_pyerror(s);
    Py_DECREF(confdict);
    PyGILState_Release(g);
    return s; /* error readable via evql_server_geterror */
  }
  PyObject* srv = PyObject_CallMethod(mod, "create", "O", confdict);
  Py_DECREF(confdict);
  Py_DECREF(mod);
  if (!srv) {
    set_pyerror(s);
    PyGILState_Release(g);
    return s;
  }
  s->pyserver = srv;
  PyGILState_Release(g);

  /* if we booted the interpreter, release the GIL so server threads run */
  if (s->we_initialized_python) {
    PyEval_SaveThread();
    s->we_initialized_python = 2; /* remember we detached */
  }
  return s;
}

int evql_server_start(evql_server_t* server) {
  if (!server->pyserver) return 1;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* rc = PyObject_CallMethod(server->pyserver, "start", NULL);
  int out = 1;
  if (rc) {
    out = (int)PyLong_AsLong(rc);
    Py_DECREF(rc);
    server->started = 1;
  } else {
    set_pyerror(server);
  }
  PyGILState_Release(g);
  return out;
}

int evql_server_listen(evql_server_t* server, int kill_fd) {
  if (!server->pyserver) return 1;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* rc =
      PyObject_CallMethod(server->pyserver, "listen", "i", kill_fd);
  int out = 1;
  if (rc) {
    out = (int)PyLong_AsLong(rc);
    Py_DECREF(rc);
  } else {
    set_pyerror(server);
  }
  PyGILState_Release(g);
  return out;
}

int evql_server_handle(evql_server_t* server, int fd, int flags) {
  (void)flags;
  if (!server->pyserver) return 1;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* rc =
      PyObject_CallMethod(server->pyserver, "handle_fd", "i", fd);
  int out = 1;
  if (rc) {
    out = (int)PyLong_AsLong(rc);
    Py_DECREF(rc);
  } else {
    set_pyerror(server);
  }
  PyGILState_Release(g);
  return out;
}

/* eventql_tpu extension: the bound port after evql_server_listen (the
 * reference binds fixed configured ports; embedded tests want port 0) */
int evql_server_getport(evql_server_t* server) {
  if (!server->pyserver) return -1;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* p = PyObject_GetAttrString(server->pyserver, "port");
  int out = -1;
  if (p) {
    out = (int)PyLong_AsLong(p);
    Py_DECREF(p);
  } else {
    PyErr_Clear();
  }
  PyGILState_Release(g);
  return out;
}

void evql_server_shutdown(evql_server_t* server) {
  if (!server->pyserver) return;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* rc = PyObject_CallMethod(server->pyserver, "shutdown", NULL);
  if (rc) {
    Py_DECREF(rc);
  } else {
    PyErr_Clear();
  }
  PyGILState_Release(g);
  server->started = 0;
}

void evql_server_free(evql_server_t* server) {
  if (!server) return;
  if (server->pyserver) {
    PyGILState_STATE g = PyGILState_Ensure();
    Py_DECREF(server->pyserver);
    PyGILState_Release(g);
  }
  free(server);
}

const char* evql_server_geterror(evql_server_t* server) {
  return server->error;
}

const char* evql_server_getconf(evql_server_t* server, const char* key) {
  if (!server->pyserver) return NULL;
  PyGILState_STATE g = PyGILState_Ensure();
  const char* out = NULL;
  PyObject* mod = PyImport_ImportModule("eventql_tpu_torch.server.embedded");
  if (mod) {
    PyObject* v = PyObject_CallMethod(
        mod, "getconf", "Os", server->pyserver, key);
    if (v && v != Py_None) {
      const char* msg = PyUnicode_AsUTF8(v);
      if (msg) {
        snprintf(server->confbuf, sizeof(server->confbuf), "%s", msg);
        out = server->confbuf;
      }
    }
    Py_XDECREF(v);
    Py_DECREF(mod);
  }
  if (!out) PyErr_Clear();
  PyGILState_Release(g);
  return out;
}

int evql_server_getconfbool(evql_server_t* server, const char* key) {
  const char* v = evql_server_getconf(server, key);
  return v != NULL && strcmp(v, "true") == 0;
}
